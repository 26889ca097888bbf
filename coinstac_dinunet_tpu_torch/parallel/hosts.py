"""Multi-host federation: the mesh planes over several processes.

Port of the JAX package's ``parallel/hosts.py`` on ``torch.distributed``.
Each process holds the sites of its block of the mesh (one process per
host: a site's ranks on that host's cards), computes them as the single
controller does (:mod:`.mesh`), and every sum over sites adds one
``all_reduce`` over the process group — gloo on the CPU, NCCL across
machines' cards.

Usage (one process per host; the same script on one host is a single
process and a no-op here)::

    from coinstac_dinunet_tpu_torch.parallel import hosts
    hosts.initialize_multihost()          # from MASTER_ADDR/PORT, WORLD_SIZE, RANK
    mesh = hosts.host_aligned_site_mesh(n_sites=8)
    fed = MeshFederation(trainer, 8, devices=mesh.devices.ravel(),
                         devices_per_site=mesh.devices.shape[1])

The sharded transformer steps (:mod:`.sequence`, :mod:`.pipeline`) run
over a mesh across processes too, moving values between the ranks of two
processes with the differentiable sends and receives of this module.

The single controller (:mod:`.mesh`) writes every collective as tensor
operations over a list holding one value per rank, and moves a value from
one rank to another with ``.to()``.  When the mesh spans processes
(the global device list is the processes' equal blocks in
process order), every process runs the same controller program over the
whole mesh, and computes real values only for the ranks it owns
(:class:`Rank`); the ranks of the other processes hold ``meta`` tensors —
the same shapes and types, no storage, no launches — so the program needs
no branch on ownership, and every process knows the shape of every value.
A move (:func:`move`) from a rank of one process to a rank of another is a
``torch.distributed`` send on the first and a receive into the meta
value's shape on the second; a move within a process stays ``.to()``.

Inside a step (:func:`step_exchange`) a move of a value that takes part in
the gradient is differentiable across the processes: the send is an
autograd node whose backward receives the gradient of what it sent, the
receive one whose backward sends the gradient of what it received, each
message under a tag of its own (the moves' common order, which every
process counts alike).  The send's node returns a zero scalar that joins
the process's root of the backward (:meth:`Exchange.root`), so a process
without the loss still runs its part of the backward, and the engine runs
the nodes in reverse creation order, each process's part of the global
graph in the order the moves came.  The gradient of a parameter held by
several processes (a replicated leaf, or a shard several processes read)
is their sum (:func:`reduce_replicas`, one ``all_reduce``: GSPMD's gradient
reduction).

Transport: the process group's backend.  NCCL takes device tensors; gloo
has no CUDA send or receive, so a card's tensor is staged through host
memory there (:func:`host_staged`), explicitly: the compute stays on the
card.  With one process none of this runs, and every move is ``.to()``.
"""
import contextlib
import itertools
import os

import torch

from ..config.keys import MeshAxis

META = torch.device("meta")
_TAGS = 2 ** 28  # each move takes tags 2i (its value) and 2i + 1 (its gradient)
_COUNTER = itertools.count()
_ACTIVE = []


def world():
    """``(process index, process count)`` of the default process group,
    ``(0, 1)`` without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_staged():
    """Whether a card's tensor crosses processes through host memory: the
    gloo backend has no CUDA send or receive."""
    return torch.distributed.get_backend() == "gloo"


class Rank:
    """A rank of a mesh: its device and the process that computes it.
    ``place`` is where this process holds the rank's values: the device
    for its own ranks, ``meta`` for the others'."""

    __slots__ = ("device", "owner")

    def __init__(self, device, owner=0):
        self.device = device
        self.owner = int(owner)

    @property
    def mine(self):
        return self.owner == world()[0]

    @property
    def place(self):
        return self.device if self.mine else META

    def __repr__(self):
        return f"Rank({self.device}, process {self.owner})"


def absent(t):
    """A meta tensor of ``t``'s shape and type: a value another process
    holds."""
    return torch.empty(t.shape, dtype=t.dtype, device=META).requires_grad_(t.requires_grad)


class Exchange:
    """The cross-process moves of one step: the sends in flight (their
    buffers kept until they complete), the send nodes' zero outputs and
    the anchor every receive node hangs from."""

    def __init__(self):
        self.sends = []
        self.roots = []
        self.anchor = torch.zeros((), requires_grad=True)

    def root(self, loss):
        """The scalar this process's backward starts from: its loss (if it
        holds it) plus its send nodes' zeros; None when it has neither."""
        parts = [] if loss is None or loss.is_meta else [loss]
        parts += self.roots
        if not parts:
            return None
        total = parts[0].float()
        for p in parts[1:]:
            total = total + p.float().to(total.device)
        return total

    def wait(self):
        for work, _ in self.sends:
            work.wait()
        self.sends.clear()


@contextlib.contextmanager
def step_exchange():
    """The exchange of one step: moves inside it are differentiable across
    the processes; leaving it waits for the sends in flight."""
    ex = Exchange()
    _ACTIVE.append(ex)
    try:
        yield ex
    finally:
        _ACTIVE.pop()
        ex.wait()


def _post_send(x, peer, tag, ex):
    buf = x.detach()
    if buf.is_cuda and host_staged():
        buf = buf.cpu()  # gloo's transport: the card's tensor through host memory
    buf = buf.contiguous().reshape(-1).view(torch.uint8)
    if buf.numel() == 0:
        return
    if ex is None:
        torch.distributed.send(buf, peer, tag=tag)
    else:
        ex.sends.append((torch.distributed.isend(buf, peer, tag=tag), buf))


def _receive(like, device, peer, tag):
    staged = device.type == "cuda" and host_staged()
    nbytes = like.numel() * like.element_size()
    buf = torch.empty(nbytes, dtype=torch.uint8, device="cpu" if staged else device)
    if nbytes:
        torch.distributed.recv(buf, peer, tag=tag)
    out = buf.view(like.dtype).reshape(like.shape)
    return out.to(device) if staged else out


class _Send(torch.autograd.Function):
    """Sends ``x``; returns a zero for the root; the backward receives the
    gradient of ``x`` from the peer."""

    @staticmethod
    def forward(ctx, x, peer, tag, ex):
        _post_send(x, peer, tag, ex)
        ctx.meta = (absent(x.detach()), x.device, peer, tag)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        like, device, peer, tag = ctx.meta
        return _receive(like, device, peer, tag + 1), None, None, None


class _Receive(torch.autograd.Function):
    """Receives a value of ``like``'s shape onto ``device``; the backward
    sends its gradient back to the peer."""

    @staticmethod
    def forward(ctx, anchor, like, device, peer, tag, ex):
        ctx.meta = (peer, tag, ex)
        return _receive(like, device, peer, tag)

    @staticmethod
    def backward(ctx, g):
        peer, tag, ex = ctx.meta
        _post_send(g, peer, tag + 1, ex)
        return None, None, None, None, None, None


def move(x, src, dst):
    """``x``, held at rank ``src``, as rank ``dst`` holds it (both
    :class:`Rank`): ``.to()`` within a process; across two, a send on
    ``src``'s process and a receive on ``dst``'s (a meta value on every
    process but ``dst``'s).  Every process calls it for every move, in the
    same order."""
    if src.owner == dst.owner:
        return x.to(dst.place)
    tag = 2 * (next(_COUNTER) % _TAGS)
    me = world()[0]
    ex = _ACTIVE[-1] if _ACTIVE else None
    grad = ex is not None and x.requires_grad and torch.is_grad_enabled()
    if src.owner == me:
        if grad:
            ex.roots.append(_Send.apply(x, dst.owner, tag, ex))
        else:
            _post_send(x, dst.owner, tag, ex)
        return absent(x)
    if dst.owner == me:
        if grad:
            return _Receive.apply(ex.anchor, x.detach(), dst.device, src.owner, tag, ex)
        return _receive(x, dst.device, src.owner, tag)
    return x


def _comm_device():
    if torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_replicas(ts):
    """Each held tensor of ``ts`` (the same list structure in every
    process, meta where a process holds none) summed over the processes
    that hold it: one ``all_reduce`` of the float32 values."""
    if world()[1] == 1:
        return ts
    dev = _comm_device()
    flat = torch.cat([torch.zeros(t.numel(), device=dev) if t.is_meta
                      else t.detach().float().reshape(-1).to(dev) for t in ts])
    torch.distributed.all_reduce(flat)
    out, at = [], 0
    for t in ts:
        n = t.numel()
        out.append(t if t.is_meta else flat[at:at + n].reshape(t.shape).to(t.device, t.dtype))
        at += n
    return out


def share(t, device):
    """A value one process holds (meta on the others) on every process, on
    ``device``; ``t`` itself with one process."""
    if world()[1] == 1:
        return t
    buf = (torch.zeros(t.shape, dtype=torch.float32, device=_comm_device()) if t.is_meta
           else t.detach().float().to(_comm_device()))
    torch.distributed.all_reduce(buf)
    return buf.to(device, t.dtype)


def gather_leaves(ts):
    """Every tensor of ``ts`` whole on every process, as CPU tensors: each
    from the lowest process that holds it (the copies are equal)."""
    if world()[1] == 1:
        return [t.detach().cpu() for t in ts]
    me, n = world()
    dev = _comm_device()
    holder = torch.tensor([n if t.is_meta else me for t in ts], device=dev)
    torch.distributed.all_reduce(holder, op=torch.distributed.ReduceOp.MIN)
    holder = holder.tolist()
    flat = torch.cat([t.detach().float().reshape(-1).to(dev) if h == me
                      else torch.zeros(t.numel(), device=dev) for t, h in zip(ts, holder)])
    torch.distributed.all_reduce(flat)
    out, at = [], 0
    for t in ts:
        out.append(flat[at:at + t.numel()].reshape(t.shape).cpu())
        at += t.numel()
    return out


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None,
                         backend=None):
    """Join the process group (``torch.distributed.init_process_group``).

    Arguments default to the standard variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``coordinator_address`` is ``host:port``),
    ``WORLD_SIZE`` and ``RANK``.  ``backend`` defaults to NCCL with a card
    and gloo without; ranks on the CPU of a host with a card need
    ``backend="gloo"``.  Without any of the first three (one process) it is
    a no-op and returns False, so the same script runs on one host or
    many."""
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    nproc = num_processes if num_processes is not None else os.environ.get("WORLD_SIZE")
    if process_id is None:
        process_id = os.environ.get("RANK")
    if addr is None and nproc is None and process_id is None:
        return False  # one process: nothing to join
    if addr is None or nproc is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address, the process "
                         f"count and this process's index (got {addr!r}, {nproc!r}, "
                         f"{process_id!r})")
    torch.distributed.init_process_group(
        backend=backend or ("nccl" if torch.cuda.is_available() else "gloo"),
        init_method=f"tcp://{addr}", world_size=int(nproc), rank=int(process_id))
    return True


def host_aligned_site_mesh(n_sites, devices_per_site=None, local_devices=None):
    """``(site, device)`` mesh whose device axis never crosses a host.

    ``local_devices`` (default: every visible card) are this process's; the
    global list is every process's, in process order (one layout on every
    host).  Sites are laid out so every site's ranks belong to one process,
    so the intra-site sums stay on a host and only the cross-site mean
    crosses processes.  Falls back to :func:`~.mesh.build_site_mesh` over
    the global list when sites must span hosts."""
    from .mesh import build_site_mesh, grid, resolve_devices

    local = resolve_devices(local_devices)
    n_hosts = world()[1]
    devices = local * n_hosts
    if devices_per_site is None:
        devices_per_site = max(len(devices) // n_sites, 1)
    per_host = len(local)
    if (n_hosts > 1 and devices_per_site <= per_host and per_host % devices_per_site == 0
            and n_sites * devices_per_site <= len(devices)):
        return grid(devices, n_sites, devices_per_site, (MeshAxis.SITE, MeshAxis.DEVICE))
    return build_site_mesh(n_sites, devices, devices_per_site)

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
"""
import os

import torch

from ..config.keys import MeshAxis
from .mesh import build_site_mesh, grid, resolve_devices, world


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

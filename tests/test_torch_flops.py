"""The port's FLOP count (``telemetry/perf.py`` ``step_cost``,
``step_flops``, ``record_jit_cost``; the attention operators of
``ops/flash_attention.py``) against the closed forms of ``models/flops.py``
and the JAX package's count, on the CPU at small sizes: the VBM CNN at
width 4 on 16³, the transformer at d_model 32, 2 heads, T 64, and the FSV
MLP.

- The count of a ``grads`` and a ``train`` step of ``k`` micro-batches
  equals ``k`` times the closed form, as integers, in float32 and under
  bfloat16 autocast.
- Attention counts once, from its shapes: ``4·BH·Tq·Tk·d`` forward and
  ``8·BH·Tq·Tk·d`` backward whatever runs inside the operator (the plain
  version's products on the CPU, a kernel the counter cannot see on the
  card), the masks or the dtype.
- Against JAX: the port's count less its attention lies within a band,
  stated per model, of JAX's ``step_flops`` of the same one-micro-batch
  step less JAX's count of its attention calls alone.  The causes, each
  measured here: XLA counts the multiply-adds on unpadded inputs only
  (a SAME stride-2 3³ convolution loses its pad taps: the VBM CNN's count
  is under the port's), and it adds the elementwise work (norms, GELU,
  the loss, the masks: the transformer's and the MLP's are over the
  port's).  A third cause is kept out of the band by comparing one
  micro-batch: XLA counts the body of the ``lax.scan`` over ``k``
  micro-batches once, whatever ``k``.
- When the trainers count: each step's first call on a fresh model and
  every call on new batch shapes, under the enabled recorder only, and the
  counted call leaves no throughput sample; the site-vectorized plane
  counts its first ``fed_step``.
- Failures are typed: ``cost_analysis_unavailable`` for a call with no
  product, ``count_failed: ...`` when the counter fails, a
  ``perf:cost_unavailable`` event for either; an error of the step itself
  propagates.
- ``jit_cost`` and ``perf:backend`` records are shaped as JAX's (no
  ``bytes_accessed``: the counter gives none).
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from coinstac_dinunet_tpu_torch import telemetry
from coinstac_dinunet_tpu_torch.models import (FSVTrainer, MultiNetTrainer, ResNetTrainer,
                                               SeqTrainer, VBMTrainer)
from coinstac_dinunet_tpu_torch.models import flops as closed
from coinstac_dinunet_tpu_torch.telemetry import perf

fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")

B, K = 3, 2
SEQ = dict(d_model=32, num_heads=2, num_layers=2, max_len=64, num_features=8, seq_len=64)

#: model → (port trainer, cache, batch input shape, closed form of one
#: micro-batch of B, its attention part)
MODELS = {
    "vbm": (VBMTrainer, {"input_shape": [16, 16, 16], "model_width": 4},
            (16, 16, 16), closed.vbm_grads_flops(B, (16, 16, 16), width=4), 0),
    "seq": (SeqTrainer, dict(SEQ), (64, 8),
            closed.seq_grads_flops(B, 64, num_features=8, d_model=32, num_heads=2,
                                   num_layers=2),
            closed.seq_attention_flops(B, 64, d_model=32, num_heads=2, num_layers=2)),
    "fsv": (FSVTrainer, {"input_size": 66}, (66,), closed.fsv_grads_flops(B), 0),
}

#: (JAX count − JAX attention) / (port count − attention), per model, at
#: one micro-batch of B in float32: the measured ratio ± 3 %.  VBM 0.796:
#: XLA leaves out the pad taps of the stride-2 convolutions (and adds the
#: GroupNorms'); transformer 1.068 and MLP 1.130: XLA adds the elementwise
#: work (LayerNorm, GELU, the loss, the masks) to the same products.
JAX_BAND = {"vbm": (0.77, 0.83), "seq": (1.03, 1.10), "fsv": (1.10, 1.16)}


def _batch(name, rows=B, seed=0):
    shape = MODELS[name][2]
    rng = np.random.default_rng(seed)
    return {"inputs": rng.normal(size=(rows, *shape)).astype(np.float32),
            "labels": rng.integers(0, 2, rows).astype(np.int32),
            "_mask": np.ones(rows, np.float32)}


def _trainer(name, tmp_path=None, dtype="float32", **extra):
    cls, cache = MODELS[name][:2]
    cache = {**cache, "seed": 0, "compute_dtype": dtype, **extra}
    state = {"outputDirectory": str(tmp_path)} if tmp_path is not None else {}
    return cls(cache=cache, state=state, device="cpu").init_nn()


def _load(out_dir):
    recs = []
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("telemetry."):
            with open(os.path.join(out_dir, name)) as f:
                recs += [json.loads(line) for line in f]
    return recs


#: the models without a JAX band: (port trainer, cache, batch input
#: shape, closed form of one micro-batch of B)
MORE_MODELS = {
    "resnet": (ResNetTrainer, {"input_shape": [33, 31, 3], "model_width": 4}, (33, 31, 3),
               closed.resnet18_grads_flops(B, (33, 31, 3), width=4)),
    "multinet": (MultiNetTrainer, {"input_shape": [16, 15, 16], "model_width": 4},
                 (16, 15, 16), closed.multinet_grads_flops(B, (16, 15, 16), width=4)),
}


# ------------------------------------------------------- the closed forms
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MORE_MODELS))
def test_resnet_and_multinet_counts_equal_the_closed_form(name, dtype):
    """ResNet-18 (an odd image, so every SAME pad is uneven) and the two
    VBM nets: the count of ``k`` micro-batches is ``k`` times the closed
    form, as integers, for ``grads`` and ``train``."""
    cls, cache, shape, want = MORE_MODELS[name]
    trainer = cls(cache={**cache, "seed": 0, "compute_dtype": dtype}, device="cpu").init_nn()
    rng = np.random.default_rng(0)
    batches = trainer._stack_batches([
        {"inputs": rng.normal(size=(B, *shape)).astype(np.float32),
         "labels": rng.integers(0, 2, B).astype(np.int32), "_mask": np.ones(B, np.float32)}
        for _ in range(K)])
    cost, reason = perf.step_cost(trainer._grads, batches)
    assert reason is None
    assert int(cost["flops"]) == K * want
    assert cost["flops"] == sum(cost["ops"].values())
    flops, reason = perf.step_flops(trainer._train, batches)
    assert reason is None and int(flops) == K * want


def test_config_4_and_5_closed_forms():
    """Config 4 (ResNet-18, 64×64×3, width 64) and config 5 (two VBM nets,
    32³, width 16) per sample: the sum of their layers' products."""
    per_sample = closed.resnet18_grads_flops(1)
    assert closed.resnet18_grads_flops(256) == 256 * per_sample
    stem = closed.conv_flops(1, (32, 32), 3, 64, k=7, input_grad=False)
    assert stem == 2 * 32 * 32 * 3 * 64 * 49 * 2
    # stem; stage 1 (4 convs at 16², 64→64); stages 2–4 (each: 3 convs of
    # c→c, one 3×3 and one 1×1 of c/2→c at 16·16/4^i positions, the same
    # multiply-adds); the head
    stage = 6 * (64 * 64 * 128 * 9 + 3 * 64 * 128 * 128 * 9 + 64 * 64 * 128)
    assert per_sample == stem + 6 * 4 * 256 * 64 * 64 * 9 + 3 * stage + 2 * 512 * 2 * 3
    assert per_sample == 869_013_504
    assert closed.multinet_grads_flops(128, (32, 32, 32), 16) == \
        2 * closed.vbm_grads_flops(128, (32, 32, 32), 16)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_grads_and_train_counts_equal_the_closed_form(name, dtype):
    want, attention = MODELS[name][3], MODELS[name][4]
    trainer = _trainer(name, dtype=dtype)
    batches = trainer._stack_batches([_batch(name), _batch(name, seed=1)])
    cost, reason = perf.step_cost(trainer._grads, batches)
    assert reason is None
    assert int(cost["flops"]) == K * want
    assert cost["flops"] == sum(cost["ops"].values())
    counted_attention = sum(n for op, n in cost["ops"].items() if op.startswith("coinn."))
    assert counted_attention == K * attention
    flops, reason = perf.step_flops(trainer._train, batches)
    assert reason is None and int(flops) == K * want


def test_the_closed_forms_at_the_main_paths_widths():
    """The prediction's arithmetic: path 2's 16-sequence step at T 4096 is
    ≈ 0.98 TFLOP, ≈ 0.825 of it attention."""
    seq = closed.seq_grads_flops(16, 4096)
    attention = closed.seq_attention_flops(16, 4096)
    assert attention == 2 * 12 * 16 * 4 * 4096 ** 2 * 32
    assert seq - attention == 6 * 16 * 4096 * 24 * 128 ** 2 + 4 * 16 * 4096 * 16 * 128 + 6 * 16 * 128 * 2
    assert 0.97e12 < seq < 0.99e12
    # the VBM at width 16 on 64³: 6·MACs of each stage but the stem's 4
    vbm = closed.vbm_grads_flops(16, (64, 64, 64))
    stem = 2 * 16 * 32 ** 3 * 16 * 27 * 2
    assert vbm > stem and vbm % 2 == 0


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("causal,kv_len", [(False, None), (True, None), (False, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_is_counted_once_from_its_shapes(causal, kv_len, dtype):
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=(2, 3, 48, 16)), dtype=dtype, requires_grad=True)
               for _ in range(3))
    with FlopCounterMode(display=False) as counter:
        out = fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        out.float().sum().backward()
    ops = {str(op): n for op, n in counter.get_flop_counts()["Global"].items()}
    # the plain version's matmuls inside the operators are not added
    assert ops == {"coinn.flash_fwd": 4 * 6 * 48 * 48 * 16,
                   "coinn.flash_bwd": 8 * 6 * 48 * 48 * 16}
    assert fa.attention_flops(6, 48, 48, 16) == ops["coinn.flash_fwd"]
    assert fa.attention_flops(6, 48, 48, 16, backward=True) == ops["coinn.flash_bwd"]


def test_attention_count_does_not_depend_on_what_runs_inside(monkeypatch):
    """The card's kernels are invisible to the counter: stand in for them
    with functions that dispatch no product, and the count is the plain
    version's."""
    def counted():
        q = torch.ones(2, 2, 32, 16, requires_grad=True)
        with FlopCounterMode(display=False) as counter:
            fa.flash_attention(q, q, q).sum().backward()
        return counter.get_total_flops()

    plain = counted()

    def no_product(fwd, bwd):
        def f(t, cuda_fn, plain_fn):
            return fwd if plain_fn is fa.flash_forward_plain else bwd
        return f

    def fwd(q, k, v, *args):
        return torch.zeros(q.shape), torch.zeros(q.shape[:2])

    def bwd(q, k, v, *args):
        return torch.zeros(q.shape), torch.zeros(k.shape), torch.zeros(v.shape)

    monkeypatch.setattr(fa, "_dispatch", no_product(fwd, bwd))
    assert counted() == plain == 12 * 4 * 32 * 32 * 16


# -------------------------------------------------------------- vs. JAX
def _jax_step_flops(name):
    """JAX's count of the one-micro-batch ``grads`` step and of its
    attention calls alone (forward and backward, every block)."""
    import jax
    import jax.numpy as jnp

    from coinstac_dinunet_tpu.models import FSVTrainer as JFSV
    from coinstac_dinunet_tpu.models import SeqTrainer as JSeq
    from coinstac_dinunet_tpu.models import VBMTrainer as JVBM
    from coinstac_dinunet_tpu.ops.flash_attention import flash_attention as jax_attention
    from coinstac_dinunet_tpu.telemetry import perf as jax_perf

    cls = {"vbm": JVBM, "seq": JSeq, "fsv": JFSV}[name]
    cache = {**MODELS[name][1], "seed": 0, "local_data_parallel": False}
    jt = cls(cache=cache, state={}, data_handle=None)
    jt.init_nn()
    stacked = jt._stack_batches([_batch(name)])
    flops, reason = jax_perf.step_flops(
        lambda ts, st: jt._grads_uncompiled(ts, st, *jt._metrics_shell())[0],
        jt.train_state, stacked)
    assert reason is None
    attention = 0.0
    if name == "seq":
        hd = SEQ["d_model"] // SEQ["num_heads"]
        x = jnp.ones((B, SEQ["num_heads"], SEQ["seq_len"], hd), jnp.float32)

        def attn(q, k, v):
            out, vjp = jax.vjp(lambda q, k, v: jax_attention(q, k, v), q, k, v)
            return vjp(out)

        one, reason = jax_perf.step_flops(attn, x, x, x)
        assert reason is None
        attention = SEQ["num_layers"] * one
    return flops, attention


@pytest.mark.parametrize("name", sorted(MODELS))
def test_count_less_attention_within_the_band_of_jax(name):
    want, attention = MODELS[name][3], MODELS[name][4]
    trainer = _trainer(name)
    ours, reason = perf.step_flops(trainer._grads, trainer._stack_batches([_batch(name)]))
    assert reason is None and int(ours) == want
    theirs, theirs_attention = _jax_step_flops(name)
    ratio = (theirs - theirs_attention) / (ours - attention)
    lo, hi = JAX_BAND[name]
    assert lo <= ratio <= hi, f"{name}: {ratio:.4f} outside [{lo}, {hi}]"


def test_xla_counts_the_micro_batch_scan_once():
    """Why the band compares one micro-batch: JAX's count of the same step
    over 1 and over 3 micro-batches differs by the ``lax.scan``'s
    bookkeeping only, where the port's triples."""
    from coinstac_dinunet_tpu.models import FSVTrainer as JFSV
    from coinstac_dinunet_tpu.telemetry import perf as jax_perf

    jt = JFSV(cache={"input_size": 66, "seed": 0, "local_data_parallel": False},
              state={}, data_handle=None)
    jt.init_nn()
    counts = []
    for k in (1, 3):
        stacked = jt._stack_batches([_batch("fsv")] * k)
        flops, _ = jax_perf.step_flops(
            lambda ts, st: jt._grads_uncompiled(ts, st, *jt._metrics_shell())[0],
            jt.train_state, stacked)
        counts.append(flops)
    assert counts[1] < 1.1 * counts[0]
    trainer = _trainer("fsv")
    ours = [perf.step_flops(trainer._grads, trainer._stack_batches([_batch("fsv")] * k))[0]
            for k in (1, 3)]
    assert ours[1] == 3 * ours[0]


# ------------------------------------------------------- when the trainers count
def test_first_step_counted_recount_on_new_shapes(tmp_path):
    cache_extra = {"profile": True, "peak_tflops": 2.0}
    trainer = _trainer("fsv", tmp_path, **cache_extra)
    rec = telemetry.Recorder("site_0", cache=trainer.cache, out_dir=str(tmp_path))
    four = trainer._stack_batches([_batch("fsv", 4)] * 2)
    five = trainer._stack_batches([_batch("fsv", 5)] * 2)
    with telemetry.activate(rec):
        for batches in (four, four, four, five, five, four):
            trainer.compute_grads(batches)
    rec.flush()
    lane = _load(tmp_path)
    costs = [r for r in lane if r.get("name") == "jit_cost"]
    # the fresh model's first step, then each change of shapes
    assert [int(r["flops"]) for r in costs] == [2 * closed.fsv_grads_flops(n) for n in (4, 5, 4)]
    assert all(r["fn"] == "grads" and r["cat"] == "compile" for r in costs)
    assert trainer.cache[perf.FLOPS_CACHE_KEY]["grads"] == costs[-1]["flops"]
    series = {}
    for r in lane:
        if r.get("kind") == "metric":
            series.setdefault(r["name"], []).append(r)
    # no throughput sample on the three counted steps
    assert len(series["samples_per_sec"]) == 3
    assert len(series["achieved_tflops"]) == len(series["mfu"]) == 3
    for a, m in zip(series["achieved_tflops"], series["mfu"]):
        assert m["value"] == pytest.approx(a["value"] / 2.0)
    (backend,) = [r for r in lane if r.get("name") == "perf:backend"]
    assert backend["device_kind"] == "cpu" and backend["peak_source"] == "cache"


def test_counter_off_when_telemetry_off(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("counted with telemetry off")

    monkeypatch.setattr(perf, "_counted_call", refuse)
    trainer = _trainer("fsv", tmp_path)
    batches = trainer._stack_batches([_batch("fsv")])
    trainer.compute_grads(batches)
    trainer.train_step(batches)
    assert perf.FLOPS_CACHE_KEY not in trainer.cache
    # enabled, the ambient recorder counts
    rec = telemetry.Recorder("site_0", cache={"profile": True}, out_dir=str(tmp_path))
    with telemetry.activate(rec), pytest.raises(AssertionError, match="telemetry off"):
        _trainer("fsv", tmp_path).compute_grads(batches)


def test_site_vectorized_plane_counts_its_first_fed_step(tmp_path):
    from coinstac_dinunet_tpu_torch.federation import SiteVectorizedEngine
    from coinstac_dinunet_tpu_torch.models import FSVDataset
    from test_torch_subprocess_engine import ARGS, TASK, fill_sites

    eng = SiteVectorizedEngine(tmp_path, n_sites=2, trainer_cls=FSVTrainer,
                               dataset_cls=FSVDataset, device="cpu", task_id=TASK,
                               profile=True, peak_tflops=1.0, **ARGS)
    fill_sites(eng)
    eng.run()
    assert eng.success
    lane = _load(tmp_path)
    (cost,) = [r for r in lane if r.get("name") == "jit_cost"]
    rows = 2 * int(ARGS["batch_size"])
    hidden = ARGS.get("hidden_sizes", (256, 128, 64))
    per_batch = closed.fsv_grads_flops(rows, int(ARGS.get("input_size", 66)), hidden)
    assert cost["fn"] == "fed_step" and int(cost["flops"]) % per_batch == 0
    mfu = [r for r in lane if r.get("name") == "mfu"]
    fed = [r for r in lane if r.get("name") == "samples_per_sec" and r.get("fn") == "fed_step"]
    assert len(mfu) == len(fed) == eng.rounds - 1
    assert all(0 < r["value"] for r in mfu)


# ------------------------------------------------------------ typed failures
def test_typed_reasons_on_failure(tmp_path, monkeypatch):
    calls = []

    def no_product(x):
        calls.append(1)
        return x + 1

    flops, reason = perf.step_flops(no_product, torch.ones(3))
    assert flops is None and reason == perf.COST_UNAVAILABLE and calls == [1]

    def broken_enter(self):
        raise RuntimeError("no dispatch mode")

    monkeypatch.setattr(perf.FlopCounterMode, "__enter__", broken_enter)
    cost, reason = perf.step_cost(lambda x: x @ x, torch.ones(2, 2))
    assert cost is None and reason == "count_failed: no dispatch mode"

    cache = {"profile": True}
    rec = telemetry.Recorder("site_0", cache=cache, out_dir=str(tmp_path))
    out, flops = perf.record_jit_cost(cache, "grads", no_product, (torch.ones(2),),
                                      recorder=rec)
    rec.flush()
    # the step ran once, its result is handed back, the failure is an event
    assert flops is None and torch.equal(out, torch.full((2,), 2.0)) and len(calls) == 2
    (ev,) = [r for r in _load(tmp_path) if r.get("name") == "perf:cost_unavailable"]
    assert ev["fn"] == "grads" and ev["reason"].startswith("count_failed:")
    assert perf.FLOPS_CACHE_KEY not in cache


def test_an_error_of_the_step_propagates():
    def step(x):
        x @ x
        raise ValueError("the step's own")

    with pytest.raises(ValueError, match="the step's own"):
        perf.step_flops(step, torch.ones(2, 2))
    # the counter is gone: a later count starts clean
    assert perf.step_flops(lambda x: x @ x, torch.ones(2, 2)) == (16.0, None)


def test_jit_cost_and_backend_records_are_shaped_as_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from coinstac_dinunet_tpu import telemetry as jax_telemetry
    from coinstac_dinunet_tpu.telemetry import perf as jax_perf

    got = {}
    for pkg in ("port", "jax"):
        cache = {"profile": True, "peak_tflops": 3.0, "mfu_ceiling": 0.5}
        tel = telemetry if pkg == "port" else jax_telemetry
        rec = tel.Recorder("site_0", cache=cache, out_dir=str(tmp_path / pkg))
        if pkg == "port":
            _, flops = perf.record_jit_cost(cache, "grads", lambda x: x @ x,
                                            (torch.ones(4, 4),), recorder=rec)
        else:
            flops = jax_perf.record_jit_cost(cache, "grads", jax.jit(lambda x: x @ x),
                                             (jnp.ones((4, 4), jnp.float32),), recorder=rec)
        rec.flush()
        got[pkg] = ({r["name"]: r for r in _load(tmp_path / pkg) if r.get("kind") == "event"},
                    cache[perf.FLOPS_CACHE_KEY]["grads"], flops)
    port, jax_side = got["port"][0], got["jax"][0]
    assert set(port) == set(jax_side) == {"perf:backend", "jit_cost"}
    assert set(jax_side["jit_cost"]) - set(port["jit_cost"]) == {"bytes_accessed"}
    assert set(port["jit_cost"]) <= set(jax_side["jit_cost"])
    assert port["jit_cost"]["cat"] == jax_side["jit_cost"]["cat"] == "compile"
    assert set(port["perf:backend"]) == set(jax_side["perf:backend"])
    for key in ("peak_tflops", "peak_source", "ceiling_mfu", "cat"):
        assert port["perf:backend"][key] == jax_side["perf:backend"][key]
    assert got["port"][1] == got["port"][2] == 2 * 4 ** 3

"""Resilience layer (port of the JAX package's ``resilience/``): the
integrity-checked atomic wire transport and its background committer
(:mod:`.transport`), retry and
backoff policies (:mod:`.retry`), and the deterministic chaos harness
(:mod:`.chaos`: JSON fault plans pinning crashes, hangs, slow sites,
payload damage, relay faults, replays and worker kills to rounds and
sites)."""
from .chaos import (
    NULL_CHAOS,
    ChaosCrash,
    ChaosFault,
    ChaosHang,
    ChaosReappear,
    ChaosSession,
    churn_plan,
    fraction_kill_plan,
    load_fault_plan,
    slow_site_plan,
)
from .retry import RetryExhausted, RetryPolicy
from .transport import WireCorruption, WireError, WireIncomplete, atomic_copy, flush_async

__all__ = ["NULL_CHAOS", "ChaosCrash", "ChaosFault", "ChaosHang", "ChaosReappear", "ChaosSession",
           "churn_plan", "fraction_kill_plan", "load_fault_plan", "slow_site_plan",
           "RetryExhausted", "RetryPolicy", "WireError", "WireCorruption", "WireIncomplete",
           "atomic_copy", "flush_async"]

"""The port's dinulint CLI: ``python -m coinstac_dinunet_tpu_torch.analysis``.

The JAX package's flags for every tier, plus ``--device`` for the tiers
that run entry points (``--deep``, ``--tier3``, ``--tier7``); the JAX
package's ``--jax-version`` is ``--torch-version`` here.  Exit status: 0
when no *new* (non-baselined, non-suppressed) findings, 1 otherwise, 2 on
usage errors (a ``--device`` that is not there among them)."""
import argparse
import json
import os
import sys

from .core import (
    default_rules,
    filter_baselined,
    load_baseline,
    run_lint,
    write_baseline,
)

from ..config.keys import Numerics
from .jax_api import TorchApiDriftRule
from .numerics import NUMERICS_STATIC_RULE_IDS

DEFAULT_BASELINE = "dinulint_torch_baseline.json"


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m coinstac_dinunet_tpu_torch.analysis",
        description="dinulint for the PyTorch port: federated-protocol, mesh, "
                    "wire and entry-point analysis",
    )
    p.add_argument("paths", nargs="*", default=["coinstac_dinunet_tpu_torch"],
                   help="files or directories to lint (default: the port)")
    p.add_argument("--format", choices=("text", "json", "github"), default="text",
                   help="'github' renders new findings as ::error workflow "
                        "annotations (plus the text summary)")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default: ./{DEFAULT_BASELINE} if present)")
    p.add_argument("--write-baseline", action="store_true",
                   help="rewrite the baseline with the current findings and exit 0")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--torch-version", default=None,
                   help="pin the torch version for torch-api-drift "
                        "(default: installed torch metadata)")
    p.add_argument("--jax-version", default=None, help=argparse.SUPPRESS)
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--show-baselined", action="store_true",
                   help="also print findings matched by the baseline")
    p.add_argument("--deep", action="store_true",
                   help="also build and run the registered entry points on "
                        "--device, twice each (imports torch)")
    p.add_argument("--deep-entries", default=None,
                   help="comma-separated entry-point names for --deep "
                        "(default: all registered)")
    p.add_argument("--list-deep", action="store_true",
                   help="list the registered deep-check entry points")
    p.add_argument("--tier3", action="store_true",
                   help="also run the phase-machine model (proto-flow-*/"
                        "proto-cache-*) and perf-host-sync over the entry "
                        "points' second runs on --device (imports torch; "
                        "composes with --deep, sharing the runs)")
    p.add_argument("--device", default=None,
                   help="the device --deep, --tier3 and --tier7 run the entry "
                        "points on (default: cuda; cpu only when named)")
    p.add_argument("--model", action="store_true",
                   help="also run the federation protocol model checker: "
                        "exhaustively explore N site machines + the "
                        "aggregator + the relay channel under the chaos fault "
                        "alphabet (pure Python, no torch)")
    p.add_argument("--model-sites", type=int, default=None,
                   help="site count of the explored model (default: "
                        "ModelCheck.DEFAULT_SITES)")
    p.add_argument("--model-rounds", type=int, default=None,
                   help="federated rounds inside the exploration bound "
                        "(default: ModelCheck.DEFAULT_ROUNDS)")
    p.add_argument("--model-faults", type=int, default=None,
                   help="fault budget per explored run (default: "
                        "ModelCheck.DEFAULT_FAULT_BUDGET)")
    p.add_argument("--model-staleness", type=int, default=None,
                   help="async staleness window k explored alongside lockstep "
                        "(0 disables the async dimension; default: "
                        "ModelCheck.DEFAULT_STALENESS_K)")
    p.add_argument("--model-elastic", type=int, default=None, choices=(0, 1),
                   help="explore the elastic-membership dimension alongside "
                        "the fixed roster; 0 disables it (default: "
                        "ModelCheck.DEFAULT_ELASTIC)")
    p.add_argument("--model-plans", default=None, metavar="DIR",
                   help="write each proto-model-* counterexample as an "
                        "executable resilience/chaos.py fault plan JSON into DIR")
    p.add_argument("--wire", action="store_true",
                   help="also run the wire-contract auditor: lift every "
                        "boundary-crossing artifact into the wire-schema IR and "
                        "check wire-orphan/wire-unversioned/wire-dense and "
                        "wire-lock drift (pure ast, no torch)")
    p.add_argument("--write-lock", action="store_true",
                   help="rewrite the port's wire-schema lockfile from the "
                        "current extraction instead of reporting drift")
    p.add_argument("--wire-lock", default=None, metavar="FILE",
                   help="wire-schema lockfile path (default: "
                        "./wire_schema_torch.lock.json)")
    p.add_argument("--wire-ledger", default=None, metavar="FILE",
                   help="also write the static byte-cost ledger JSON")
    p.add_argument("--reconcile", default=None, metavar="DIR",
                   help="compare the static byte ledger against the telemetry "
                        "wire records under DIR; unaccounted observed bytes "
                        "report as wire-unmodeled")
    p.add_argument("--tier5", action="store_true",
                   help="also run the tier-5 concurrency auditor: the static "
                        "conc-* lock-discipline rules (pure AST) plus the "
                        "proto-conc-* interleaving explorer over the real async "
                        "round loop under virtual time (numpy stubs)")
    p.add_argument("--schedules", default=None, metavar="DIR",
                   help="write each proto-conc-* counterexample as a replayable "
                        "schedule JSON into DIR")
    p.add_argument("--schedule-bound", type=int, default=None,
                   help="post-warmup rounds the interleaving explorer enumerates "
                        "completion schedules over (default: "
                        "Concurrency.DEFAULT_ROUNDS)")
    p.add_argument("--tier7", action="store_true",
                   help="also run the tier-7 numerics & determinism auditor: the "
                        "static num-* rules (pure AST), num-accum-narrow over the "
                        "entry points' runs on --device (imports torch), and the "
                        "proto-num-parity bit-parity prover")
    p.add_argument("--parity", action="store_true",
                   help="run ONLY the tier-7 bit-parity prover (numpy stubs)")
    p.add_argument("--parity-plans", default=None, metavar="DIR",
                   help="write each proto-num-parity counterexample as a "
                        "replayable parity plan JSON into DIR")
    return p


#: rule-id prefixes owned by each opt-in tier — a --write-baseline refresh
#: that did not run a tier carries its accepted entries over verbatim
TIER_PREFIXES = {
    "deep": ("deep-",),
    "tier3": ("tier3-", "perf-", "proto-flow-", "proto-cache-"),
    "model": ("proto-model-",),
    "tier5": ("conc-", "proto-conc-"),
    "tier7": ("num-", "proto-num-"),
    # tracked by EXACT rule ids, never the bare "wire-" prefix: the
    # default-tier rule wire-atomic-commit shares the spelling
    "wire": ("wire-orphan", "wire-unversioned", "wire-dense", "wire-lock",
             "wire-unmodeled", "wire-config"),
}


def _github_escape(text):
    """Escape a message for a GitHub workflow-command data section."""
    return text.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")


#: the rules --tier7 runs besides the parity prover's
TIER7_STATIC_IDS = frozenset(NUMERICS_STATIC_RULE_IDS) | {Numerics.ACCUM_NARROW}


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.jax_version is not None:
        print("--jax-version pins the JAX package's analyzer; the port reads torch: "
              "use --torch-version", file=sys.stderr)
        return 2
    rules = default_rules()
    if args.torch_version:
        rules = [TorchApiDriftRule(torch_version=args.torch_version)
                 if isinstance(r, TorchApiDriftRule) else r for r in rules]
    if args.list_rules:
        # every opt-in tier's rules, from their id lists (no torch import)
        from .concurrency import TIER5_STATIC_RULE_IDS
        from .dataflow import TIER3_RULE_IDS
        from .deepcheck import DEEP_RULE_IDS
        from .model_check import MODEL_RULE_IDS
        from .schedule_explorer import EXPLORER_RULE_IDS
        from .wire_schema import WIRE_RULE_IDS

        for r in sorted(rules, key=lambda r: r.id):
            print(f"{r.id}: {r.doc}")
        for ids, tier in ((DEEP_RULE_IDS, "deep entry points, --deep"),
                          (TIER3_RULE_IDS, "tier 3, --tier3"),
                          (MODEL_RULE_IDS, "model checker, --model"),
                          (TIER5_STATIC_RULE_IDS, "tier-5 concurrency auditor, --tier5"),
                          (EXPLORER_RULE_IDS, "tier-5 interleaving explorer, --tier5"),
                          (WIRE_RULE_IDS, "wire auditor, --wire"),
                          (sorted(TIER7_STATIC_IDS), "tier-7 numerics auditor, --tier7"),
                          ((Numerics.PARITY,), "tier-7 parity prover, --tier7/--parity")):
            for rid in ids:
                print(f"{rid}: ({tier})")
        return 0
    if args.list_deep:
        from .deepcheck import list_entry_points

        for name, path in list_entry_points().items():
            print(f"{name}: {path}")
        return 0
    if args.deep_entries and not args.deep:
        print("--deep-entries requires --deep", file=sys.stderr)
        return 2
    if args.device is not None and not (args.deep or args.tier3 or args.tier7):
        print("--device requires --deep, --tier3 or --tier7", file=sys.stderr)
        return 2

    deep_names = None
    if args.deep_entries:
        # validated BEFORE the static scan (deepcheck's import loads only
        # the registry; the builders import torch when they run)
        from .deepcheck import list_entry_points

        deep_names = [n.strip() for n in args.deep_entries.split(",") if n.strip()]
        if not deep_names:
            print("--deep-entries given but no entry names parsed", file=sys.stderr)
            return 2
        known = set(list_entry_points())
        unknown = sorted(set(deep_names) - known)
        if unknown:
            print(f"unknown deep entry point(s): {', '.join(unknown)} "
                  f"(known: {', '.join(sorted(known))})", file=sys.stderr)
            return 2
    if args.write_baseline and deep_names is not None:
        print("--write-baseline with --deep-entries would drop the other entry "
              "points' baselined deep findings; refresh over the full registry "
              "(--deep without --deep-entries) instead", file=sys.stderr)
        return 2
    if not args.model and any(
        v is not None for v in (args.model_sites, args.model_rounds, args.model_faults,
                                args.model_plans, args.model_staleness, args.model_elastic)
    ):
        print("--model-sites/--model-rounds/--model-faults/--model-plans/"
              "--model-staleness/--model-elastic require --model", file=sys.stderr)
        return 2
    for flag, value, least, why in (
            ("--model-sites", args.model_sites, 1, "need at least 1 site"),
            ("--model-rounds", args.model_rounds, 1,
             "need at least 1 federated round (0/negative bounds make every "
             "invariant vacuous or falsely violated)"),
            ("--model-faults", args.model_faults, 0,
             "the fault budget cannot be negative (0 = fault-free runs only)"),
            ("--model-staleness", args.model_staleness, 0,
             "the async window cannot be negative (0 = lockstep only)")):
        if value is not None and value < least:
            print(f"{flag} {value}: {why}", file=sys.stderr)
            return 2
    if not args.tier5 and (args.schedules is not None or args.schedule_bound is not None):
        print("--schedules/--schedule-bound require --tier5", file=sys.stderr)
        return 2
    if args.schedule_bound is not None and args.schedule_bound < 1:
        print(f"--schedule-bound {args.schedule_bound}: the explorer needs at least 1 "
              "post-warmup round (0/negative bounds make every round-loop invariant "
              "vacuous)", file=sys.stderr)
        return 2
    if not args.wire and (args.write_lock or args.wire_lock is not None
                          or args.wire_ledger is not None or args.reconcile is not None):
        print("--write-lock/--wire-lock/--wire-ledger/--reconcile require --wire",
              file=sys.stderr)
        return 2
    if args.parity_plans is not None and not (args.tier7 or args.parity):
        print("--parity-plans requires --tier7 or --parity", file=sys.stderr)
        return 2
    if args.write_baseline and args.parity and not args.tier7:
        print("--write-baseline with --parity (prover only) would drop the static "
              "num-* baselined findings; refresh with --tier7 instead", file=sys.stderr)
        return 2
    rule_ids = args.rules.split(",") if args.rules else None
    if rule_ids:
        from .concurrency import TIER5_STATIC_RULE_IDS
        from .dataflow import TIER3_RULE_IDS
        from .model_check import MODEL_RULE_IDS
        from .schedule_explorer import EXPLORER_RULE_IDS
        from .wire_schema import WIRE_RULE_IDS

        tier5_ids = set(TIER5_STATIC_RULE_IDS) | set(EXPLORER_RULE_IDS)
        known = ({r.id for r in rules} | set(TIER3_RULE_IDS) | set(MODEL_RULE_IDS)
                 | tier5_ids | set(WIRE_RULE_IDS) | TIER7_STATIC_IDS | {Numerics.PARITY})
        unknown = sorted(set(rule_ids) - known)
        if unknown:
            print(f"unknown rule id(s): {', '.join(unknown)} "
                  f"(known: {', '.join(sorted(known))})", file=sys.stderr)
            return 2
        if Numerics.PARITY in set(rule_ids) and not (args.tier7 or args.parity):
            print(f"--rules {Numerics.PARITY} requires --tier7 or --parity (the parity "
                  "prover only runs under them)", file=sys.stderr)
            return 2
        for ids, tier, ran in ((TIER3_RULE_IDS, "--tier3", args.tier3),
                               (MODEL_RULE_IDS, "--model", args.model),
                               (tier5_ids, "--tier5", args.tier5),
                               (WIRE_RULE_IDS, "--wire", args.wire),
                               (TIER7_STATIC_IDS, "--tier7", args.tier7)):
            selected = sorted(set(rule_ids) & set(ids))
            if selected and not ran:
                # without the tier the selected rule would silently report
                # nothing — a false clean for whoever reproduces a finding
                print(f"--rules {','.join(selected)} requires {tier} "
                      f"({tier} rules only run under {tier})", file=sys.stderr)
                return 2
    if args.write_baseline and rule_ids:
        print("--write-baseline with --rules would drop every other rule's "
              "baselined findings; refresh over the full rule set instead",
              file=sys.stderr)
        return 2
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"no such path(s): {', '.join(missing)}", file=sys.stderr)
        return 2
    # the tier-3 entry runs are skipped when --rules selects only the
    # pure-AST proto-* family
    tier3_entries = args.tier3 and (not rule_ids or any(
        r.startswith(("perf-", "tier3-")) for r in rule_ids))
    # num-accum-narrow runs the entries too
    tier7_entries = args.tier7 and (not rule_ids or Numerics.ACCUM_NARROW in rule_ids)
    device = args.device or "cuda"
    if args.deep or tier3_entries or tier7_entries:
        from ..config import resolve_device

        try:
            device = resolve_device(device)
        except (RuntimeError, ValueError) as exc:
            print(f"--device {args.device or 'cuda'}: {exc}", file=sys.stderr)
            return 2

    findings, errors = run_lint(args.paths, rules=rules, rule_ids=rule_ids)

    if args.tier3:
        from .dataflow import TIER3_RULE_IDS, run_tier3

        wanted = set(rule_ids) if rule_ids else None
        if wanted is not None and wanted.isdisjoint(TIER3_RULE_IDS):
            tier3_findings = []
        else:
            tier3_findings = run_tier3(names=deep_names, paths=args.paths,
                                       device=device, entries=tier3_entries)
        if wanted is not None:
            # the tier's own error channel survives any filter
            keep = wanted | {"tier3-config", "tier3-lower"}
            tier3_findings = [f for f in tier3_findings if f.rule in keep]
        findings = findings + tier3_findings
    if args.deep:
        from .deepcheck import run_deepcheck

        findings = findings + run_deepcheck(deep_names, device=device)
    if args.model:
        # pure-Python bounded exploration (no torch import)
        from .model_check import ModelConfig, run_model_check

        defaults = ModelConfig()
        staleness = defaults.staleness
        if args.model_staleness is not None:
            staleness = (0, args.model_staleness) if args.model_staleness else (0,)
        elastic = defaults.elastic
        if args.model_elastic is not None:
            elastic = (False, True) if args.model_elastic else (False,)
        cfg = ModelConfig(
            sites=args.model_sites if args.model_sites is not None else defaults.sites,
            rounds=args.model_rounds if args.model_rounds is not None else defaults.rounds,
            max_faults=(args.model_faults if args.model_faults is not None
                        else defaults.max_faults),
            staleness=staleness,
            elastic=elastic,
        )
        result = run_model_check(config=cfg, plans_dir=args.model_plans)
        model_findings = result.findings
        if rule_ids:
            keep = set(rule_ids) | {"proto-model-config"}
            model_findings = [f for f in model_findings if f.rule in keep]
        findings = findings + model_findings
        if args.tier3:
            # path-sensitive promotion: a syntactic read-before-write whose
            # read site the exhaustive exploration EXERCISED without ever
            # realizing a violation is a reachability false positive
            confirmed = {tuple(c) for c in result.report.get("confirmed_cache", [])}
            exercised = {tuple(c) for c in result.report.get("exercised_reads", [])}
            retired = [f for f in findings
                       if f.rule == "proto-cache-read-before-write"
                       and (f.path, f.line) in exercised
                       and (f.path, f.line) not in confirmed]
            if retired:
                findings = [f for f in findings if f not in retired]
                print(f"dinulint --model: retired {len(retired)} "
                      "proto-cache-read-before-write finding(s) whose read site the "
                      "explored model exercised without ever violating", file=sys.stderr)
    if args.tier5:
        # the static lock-discipline rules (pure AST) and the interleaving
        # explorer (numpy stubs, the engines on the CPU)
        from ..config.keys import Concurrency
        from .concurrency import run_tier5_static
        from .schedule_explorer import EXPLORER_RULE_IDS, ScheduleConfig, run_schedule_explorer

        wanted5 = set(rule_ids) if rule_ids else None
        tier5_findings = list(run_tier5_static(paths=args.paths))
        if wanted5 is None or not wanted5.isdisjoint(EXPLORER_RULE_IDS):
            result5 = run_schedule_explorer(config=ScheduleConfig(rounds=args.schedule_bound),
                                            schedules_dir=args.schedules)
            tier5_findings += result5.findings
        if wanted5 is not None:
            keep = wanted5 | {Concurrency.CONFIG}
            tier5_findings = [f for f in tier5_findings if f.rule in keep]
        findings = findings + tier5_findings
    if args.wire:
        # pure stdlib ast, no torch
        from ..config.keys import WireContract
        from .wire_schema import DEFAULT_LOCK, run_wire

        wire_findings, wire_schema = run_wire(
            paths=args.paths,
            lock_path=args.wire_lock or DEFAULT_LOCK,
            write_lock_file=args.write_lock,
            reconcile_dir=args.reconcile,
            ledger_path=args.wire_ledger,
        )
        if wire_schema is None and not wire_findings:
            # partial scan (single-file lint): a one-sided lift would flood
            # every key of the missing side as an orphan — skip
            print("dinulint --wire: skipped — the scanned paths do not cover the "
                  "full wire boundary file set", file=sys.stderr)
        if rule_ids:
            keep = set(rule_ids) | {WireContract.CONFIG}
            wire_findings = [f for f in wire_findings if f.rule in keep]
        findings = findings + wire_findings
        if args.write_lock and wire_schema is not None:
            print(f"wrote wire-schema lockfile to {args.wire_lock or DEFAULT_LOCK} "
                  f"({len(wire_schema.entries)} entries)")
    if args.tier7 or args.parity:
        # the static num-* rules (pure AST), num-accum-narrow over the entry
        # runs on --device, the parity prover (numpy stubs)
        from .numerics import run_accum_narrow, run_tier7_static
        from .parity import run_parity_prover

        wanted7 = set(rule_ids) if rule_ids else None
        tier7_findings = []
        if args.tier7:
            tier7_findings += list(run_tier7_static(paths=args.paths))
            if tier7_entries:
                tier7_findings += list(run_accum_narrow(device=device))
        if wanted7 is None or Numerics.PARITY in wanted7:
            tier7_findings += run_parity_prover(plans_dir=args.parity_plans).findings
        if wanted7 is not None:
            keep = wanted7 | {Numerics.CONFIG}
            tier7_findings = [f for f in tier7_findings if f.rule in keep]
        findings = findings + tier7_findings
    if args.deep or args.tier3 or args.model or args.wire or args.tier5 or args.tier7 \
            or args.parity:
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    baseline_path = args.baseline
    if baseline_path is None and os.path.exists(DEFAULT_BASELINE):
        baseline_path = DEFAULT_BASELINE

    if args.write_baseline:
        out = baseline_path or DEFAULT_BASELINE
        broken = [f.rule for f in findings
                  if f.rule in ("deep-config", "tier3-config", "proto-model-config",
                                "proto-conc-config", "wire-config", "num-config")]
        if broken:
            # an opt-in tier never actually ran — writing now would drop its
            # accepted entries AND baseline the tier's own error channel
            print(f"--write-baseline refused: {broken[0]}: the tier could not run "
                  "to completion — fix its configuration or refresh without that "
                  "tier", file=sys.stderr)
            return 2
        extra = []
        not_run = [t for t, ran in (("deep", args.deep), ("tier3", args.tier3),
                                    ("model", args.model), ("tier5", args.tier5),
                                    ("wire", args.wire), ("tier7", args.tier7)) if not ran]
        if not_run and os.path.exists(out):
            # a tier that didn't run contributes nothing to this refresh —
            # carry its accepted entries over instead of dropping them
            prefixes = tuple(p for t in not_run for p in TIER_PREFIXES[t])
            with open(out, "r", encoding="utf-8") as f:
                old = json.load(f)
            extra = [e for e in old.get("findings", [])
                     if e.get("rule", "").startswith(prefixes)]
        write_baseline(out, findings, extra_entries=extra)
        kept = (f" (+{len(extra)} entr{'y' if len(extra) == 1 else 'ies'} "
                f"kept from tiers not run: {', '.join(not_run)})" if extra else "")
        print(f"wrote {len(findings)} finding(s) to {out}{kept}")
        return 0

    baseline_counts = {}
    if baseline_path and os.path.exists(baseline_path):
        baseline_counts = load_baseline(baseline_path)
    new, baselined = filter_baselined(findings, baseline_counts)

    summary = f"{len(new)} new finding(s), {len(baselined)} baselined"
    if errors:
        summary += f", {len(errors)} parse error(s)"
    if args.format == "json":
        print(json.dumps({
            "new": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in baselined],
            "errors": [{"path": p, "error": e} for p, e in errors],
        }, indent=2))
    elif args.format == "github":
        # workflow annotations: GitHub surfaces these inline on the PR diff
        for f in new:
            print(f"::error file={f.path},line={f.line},col={f.col + 1},"
                  f"title=dinulint {f.rule}::{_github_escape(f.message)}")
        for path, err in errors:
            print(f"::error file={path},line=1,title=dinulint parse error::"
                  f"{_github_escape(err)}")
        print(summary)
    else:
        for f in new:
            print(f.render())
        if args.show_baselined:
            for f in baselined:
                print(f"{f.render()} [baselined]")
        for path, err in errors:
            print(f"{path}: parse error: {err}", file=sys.stderr)
        print(summary)

    return 1 if new or errors else 0


if __name__ == "__main__":
    sys.exit(main())

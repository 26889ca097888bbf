"""``python -m coinstac_dinunet_tpu_torch.telemetry`` — the federation timeline
CLI (PyTorch port of the JAX package's, with the same subcommands, flags and
exit codes).

Merge every node's ``telemetry.*.jsonl`` under a run directory, print the
per-phase/per-site summary table, and export a Perfetto/Chrome-trace JSON::

    python -m coinstac_dinunet_tpu_torch.telemetry <workdir> --trace trace.json

Open the trace at https://ui.perfetto.dev (or ``chrome://tracing``).

The ``doctor`` subcommand turns the same records into a postmortem report
(anomaly timeline, per-site divergence table, round-throughput trend, ranked
likely-cause verdicts)::

    python -m coinstac_dinunet_tpu_torch.telemetry doctor <workdir> \\
        --markdown postmortem.md --json postmortem.json [--format github] \\
        [--bench-history BENCH_HISTORY.jsonl]

The ``watch`` subcommand is the LIVE counterpart: it tails the same JSONL incrementally while the run is alive,
renders a refreshing terminal status board, optionally serves Prometheus
``/metrics`` + ``/healthz``, and fires edge-triggered in-flight stall
verdicts (heartbeat silence, round-duration outlier, MFU collapse,
wire-retry storm).  With ``-- cmd...`` it spawns the run itself and follows
until it exits::

    python -m coinstac_dinunet_tpu_torch.telemetry watch <workdir> --follow \\
        --until-exit --serve 9477 --assert-verdict heartbeat_silence \\
        --snapshot board.txt --metrics-out metrics.prom \\
        -- python my_federation.py --workdir <workdir>
"""
import argparse
import json
import os
import sys
import time

from .collect import load_events, render_summary, summarize, write_chrome_trace
from .doctor import (
    build_report,
    load_bench_history,
    render_github,
    render_markdown,
)


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m coinstac_dinunet_tpu_torch.telemetry",
        description="merge per-node telemetry JSONL into one federation "
                    "timeline (summary table + Perfetto trace)",
    )
    p.add_argument("root", nargs="?", default=".",
                   help="run directory scanned recursively for "
                        "telemetry.*.jsonl (default: .)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="write the merged Chrome-trace/Perfetto JSON here")
    p.add_argument("--summary-json", default=None, metavar="PATH",
                   help="write the machine-readable summary here")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the summary table on stdout")
    return p


def build_doctor_parser():
    p = argparse.ArgumentParser(
        prog="python -m coinstac_dinunet_tpu_torch.telemetry doctor",
        description="merge per-node telemetry into a postmortem report: "
                    "anomaly timeline, per-site divergence, round trend, "
                    "ranked likely-cause verdicts",
    )
    p.add_argument("root", nargs="?", default=".",
                   help="run directory scanned recursively for "
                        "telemetry.*.jsonl (default: .)")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the machine-readable report here")
    p.add_argument("--markdown", default=None, metavar="PATH",
                   help="write the markdown postmortem here")
    p.add_argument("--format", choices=("text", "github"), default="text",
                   help="'github' prints ::error/::warning workflow "
                        "annotations for the verdicts instead of markdown")
    p.add_argument("--bench-history", default=None, metavar="PATH",
                   help="bench history JSONL, one ledger line per run; "
                        "a >threshold samples/sec/chip drop vs the previous "
                        "entry becomes a verdict")
    p.add_argument("--regression-threshold", type=float, default=0.10,
                   help="bench regression fraction (default 0.10 = 10%%)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the report on stdout")
    return p


def build_watch_parser():
    p = argparse.ArgumentParser(
        prog="python -m coinstac_dinunet_tpu_torch.telemetry watch",
        description="live federation status board: tail telemetry.*.jsonl "
                    "incrementally, render a refreshing board, export "
                    "Prometheus /metrics + /healthz, and fire in-flight "
                    "stall verdicts while the run is alive",
    )
    p.add_argument("root", nargs="?", default=".",
                   help="run directory tailed recursively for "
                        "telemetry.*.jsonl (may not exist yet; default: .)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="poll/refresh seconds (default 2)")
    p.add_argument("--follow", action="store_true",
                   help="keep tailing until interrupted (default without a "
                        "command: one poll, one board, exit)")
    p.add_argument("--until-exit", action="store_true",
                   help="with a spawned command (after --): stop when the "
                        "command exits (one final poll), even under "
                        "--follow; without it, --follow keeps tailing the "
                        "directory after the command finishes")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="hard wall-clock stop for the watch loop")
    p.add_argument("--silence-after", type=float, default=30.0,
                   help="heartbeat-silence verdict threshold in seconds "
                        "(default 30)")
    p.add_argument("--round-outlier", type=float, default=4.0,
                   help="round-duration outlier multiple vs the rolling "
                        "median (default 4)")
    p.add_argument("--mfu-collapse", type=float, default=0.3,
                   help="MFU-collapse fraction of the EMA (default 0.3)")
    p.add_argument("--retry-storm", type=int, default=10,
                   help="wire retries per window that fire the retry-storm "
                        "verdict (default 10)")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve /metrics + /healthz on 127.0.0.1:PORT while "
                        "watching (0 = ephemeral port)")
    p.add_argument("--snapshot", default=None, metavar="PATH",
                   help="write the final board rendering here on exit")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the final /healthz snapshot JSON here")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write a final /metrics scrape here on exit (a real "
                        "HTTP self-scrape when --serve is up, a direct "
                        "rendering otherwise)")
    p.add_argument("--cursor-file", default=None, metavar="PATH",
                   help="persist per-file tail cursors to this sidecar so a "
                        "restarted watch resumes instead of replaying")
    p.add_argument("--assert-verdict", default=None, metavar="KIND",
                   action="append",
                   help="exit 3 unless this verdict kind fired WHILE the "
                        "run was alive (repeatable; e.g. heartbeat_silence)")
    p.add_argument("--assert-event", default=None, metavar="NAME",
                   action="append",
                   help="exit 3 unless this telemetry event name was "
                        "observed WHILE the run was alive (repeatable; "
                        "e.g. worker:restart — the daemon chaos drill's "
                        "live supervision gate)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the periodic board on stdout (the final "
                        "board still prints / lands in --snapshot)")
    p.epilog = ("everything after a literal `--` is spawned as the watched "
                "command; the watch follows it until it exits and returns "
                "its exit code")
    return p


def watch_main(argv=None):
    from .live import LiveState, Tailer, render_board
    from .serve import OpsServer, render_prometheus

    # split the spawned command off BEFORE argparse: REMAINDER's greedy
    # matching would swallow our own flags placed after the root positional
    argv = list(sys.argv[1:] if argv is None else argv)
    command = []
    if "--" in argv:
        ix = argv.index("--")
        command = argv[ix + 1:]
        argv = argv[:ix]
    parser = build_watch_parser()
    args = parser.parse_args(argv)
    if args.until_exit and not command:
        parser.error("--until-exit requires a spawned command after --")

    tailer = Tailer(args.root, cursor_path=args.cursor_file)
    state = LiveState(
        silence_after=args.silence_after, round_outlier=args.round_outlier,
        mfu_collapse=args.mfu_collapse, retry_storm=args.retry_storm,
    )
    server = None
    if args.serve is not None:
        server = OpsServer(state.snapshot, port=args.serve)
        print(f"serving /metrics + /healthz on {server.url('')}",
              file=sys.stderr)

    clear = sys.stdout.isatty() and not args.quiet

    def emit_board():
        if args.quiet:
            return
        board = render_board(state.snapshot(), root=str(args.root))
        if clear:
            sys.stdout.write("\x1b[2J\x1b[H" + board + "\n")
        else:
            sys.stdout.write(board + "\n" + "-" * 72 + "\n")
        sys.stdout.flush()

    asserted_events = list(args.assert_event or ())
    events_during_run = set()

    def step(during_run):
        """One poll + rule evaluation; stamps verdicts fired while the run
        (the child, or an unconditioned follow) was still alive."""
        before = {n: state.event_counts.get(n, 0) for n in asserted_events}
        records = tailer.poll()
        state.truncated_lines = tailer.truncated_lines
        state.ingest(records)
        if during_run:
            for n in asserted_events:
                if state.event_counts.get(n, 0) > before[n]:
                    events_during_run.add(n)
        for v in state.check():
            v["during_run"] = bool(during_run)
            line = (f"!! [{v['severity']}] {v['verdict']}"
                    + (f" [{v.get('site')}]" if v.get("site") else "")
                    + f" — {v['cause']}: {v['evidence']}")
            print(line, file=sys.stderr)

    child = None
    if command:
        import subprocess

        # drain whatever is ALREADY in the workdir before the child
        # spawns: records left by an earlier run in a reused directory
        # land with during_run=False, so they can never satisfy
        # --assert-event/--assert-verdict on behalf of the new run
        step(during_run=False)
        child = subprocess.Popen(command)

    t_start = time.monotonic()
    rc = 0
    try:
        if not (command or args.follow):
            step(during_run=False)  # one-shot board over whatever is there
        else:
            child_done = False
            while True:
                if (child is not None and not child_done
                        and child.poll() is not None):
                    child_done = True
                    rc = child.returncode or 0
                # "the run is alive": the spawned command is still running,
                # or an unconditioned --follow with no command at all
                alive = ((child is not None and not child_done)
                         or (child is None and args.follow))
                step(during_run=alive)
                emit_board()
                if child_done and (args.until_exit or not args.follow):
                    break  # --until-exit (or no --follow): stop with the run
                if (args.max_seconds is not None
                        and time.monotonic() - t_start >= args.max_seconds):
                    break
                time.sleep(max(args.interval, 0.05))
            # final drain: the run's last flush may land after its exit
            step(during_run=False)
    except KeyboardInterrupt:
        pass
    finally:
        if child is not None and child.poll() is None:
            child.terminate()

    board = render_board(state.snapshot(), root=str(args.root))
    if not args.quiet:
        print(board)
    if args.snapshot:
        with open(args.snapshot, "w", encoding="utf-8") as f:
            f.write(board + "\n")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(state.snapshot(), f, indent=2, sort_keys=True,
                      default=str)
    if args.metrics_out:
        text = (server.scrape("/metrics") if server is not None
                else render_prometheus(state.snapshot()))
        with open(args.metrics_out, "w", encoding="utf-8") as f:
            f.write(text)
    if server is not None:
        # close under a REAL recorder writing into the watched run dir:
        # the watch process has no ambient recorder, so without this the
        # typed telemetry:degraded event a failed join emits would land
        # on the null recorder and leave no postmortem evidence
        from .recorder import Recorder, activate

        rec = Recorder("watch", out_dir=str(args.root))
        with activate(rec):
            joined = server.close()
        rec.flush()
        if not joined:
            print("WARNING: ops server thread failed to join on close; "
                  "the listener may leak until process exit (typed "
                  "telemetry:degraded event recorded in "
                  f"{args.root})", file=sys.stderr)

    for kind in args.assert_verdict or ():
        hits = [v for v in state.verdicts if v["verdict"] == kind]
        if not any(v.get("during_run") for v in hits):
            print(
                f"ASSERT FAILED: verdict '{kind}' did not fire while the "
                f"run was alive ({len(hits)} fired post-run); verdicts: "
                f"{[v['verdict'] for v in state.verdicts]}",
                file=sys.stderr,
            )
            return 3
        print(f"asserted: '{kind}' fired in-flight "
              f"({len(hits)} occurrence(s))", file=sys.stderr)
    for name in asserted_events:
        total = state.event_counts.get(name, 0)
        if name not in events_during_run:
            print(
                f"ASSERT FAILED: event '{name}' was not observed while "
                f"the run was alive ({total} observed overall)",
                file=sys.stderr,
            )
            return 3
        print(f"asserted: '{name}' observed in-flight "
              f"({total} occurrence(s))", file=sys.stderr)
    return rc


def doctor_main(argv=None):
    args = build_doctor_parser().parse_args(argv)
    events = load_events(args.root)
    if not events:
        print(f"no telemetry records under {args.root!r} — enable with "
              "cache['profile']=True (README.md)", file=sys.stderr)
        return 1
    report = build_report(
        events,
        bench_history=load_bench_history(args.bench_history),
        regression_threshold=args.regression_threshold,
    )
    md = render_markdown(report)
    if args.markdown:
        with open(args.markdown, "w", encoding="utf-8") as f:
            f.write(md + "\n")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    if not args.quiet:
        print(render_github(report) if args.format == "github" else md)
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "doctor":
        return doctor_main(argv[1:])
    if argv and argv[0] == "watch":
        return watch_main(argv[1:])
    args = build_parser().parse_args(argv)
    events = load_events(args.root)
    if not events:
        print(f"no telemetry records under {args.root!r} — enable with "
              "cache['profile']=True (README.md)", file=sys.stderr)
        return 1
    summary = summarize(events)
    if not args.quiet:
        print(render_summary(summary))
    if args.summary_json:
        with open(args.summary_json, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
    if args.trace:
        trace = write_chrome_trace(args.trace, events)
        if not args.quiet:
            print(f"\nwrote {len(trace['traceEvents'])} trace events for "
                  f"{len(summary['nodes'])} nodes -> {args.trace} "
                  "(load at https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # `... | head` is a legitimate way to use this
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)

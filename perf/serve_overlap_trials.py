"""Phase 12.1 of ``chip_smoke.py`` repeated, with and without the gate.

Runs ``chip_smoke.py`` whole, with its phase 12.1 (a warm queue of four
full-size jobs through ``cli.main(["serve", ...])``) repeated ``TRIALS``
times in each of two variants, alternating: "gated", the tree as it
stands (job N+1's decode-ahead waits for job N's first pileup
dispatch), and "ungated" (the gate opened as the decode-ahead is made,
so the decode starts with job N).  A failed check of 12.1 is recorded
instead of ending the run; each trial's failures and a summary are
printed, then phase 12 runs as the smoke runs it.  Needs a CUDA card:

    TRIALS=10 python3 perf/serve_overlap_trials.py
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.chdir(REPO)
import chip_smoke as cs  # noqa: E402
import sam2consensus_torch.serve.runner as srunner  # noqa: E402

TRIALS = int(os.environ.get("TRIALS", "10"))
orig_warm_server = cs.warm_server
orig_fail = cs.fail
orig_init = srunner._DecodeAhead.__init__


def ungated_init(self, *args, **kwargs):
    orig_init(self, *args, **kwargs)
    self.gate.set()


def trials(tmp, card):
    tally = {"gated": [], "ungated": []}
    for t in range(TRIALS):
        for variant in ("gated", "ungated"):
            msgs = []
            cs.fail = msgs.append
            if variant == "ungated":
                srunner._DecodeAhead.__init__ = ungated_init
            try:
                print(f"TRIAL {t} {variant}", flush=True)
                cs.warm_queue(tmp, card)
            finally:
                srunner._DecodeAhead.__init__ = orig_init
                cs.fail = orig_fail
            tally[variant].append(msgs)
            print(f"TRIAL {t} {variant} failures: {msgs}", flush=True)
    for variant, runs in tally.items():
        zero = sum(1 for m in runs for x in m if "overlap" in x)
        print(f"SUMMARY {variant}: {sum(1 for m in runs if m)}/{len(runs)} "
              f"trials with a failed check; zero-overlap jobs: {zero}",
              flush=True)
    orig_warm_server(tmp, card)


cs.warm_server = trials
sys.exit(cs.main())

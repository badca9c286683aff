"""What the serving checks' background builds cost the phases they overlap.

    python mutant_overlap.py [--variants 4:8,2:6]

Run from the repository root on the card's machine, beside
``chip_smoke.py``, whose phases it times. ``chip_smoke.py`` builds the
planted copies of its serving checks (``serving_mutants.Prebuilt``) while
the card runs phases 2-11. The phases that also run a full-width forward
on the CPU (5, 7 and 9: MaIR-CDN's and MaIRUNet's paths and the fused
route, each with a card-against-CPU request) share the host's CPUs with
those builds. This times the three phases alone, then beside the builds
for each variant ``jobs:threads`` (``jobs`` builds at once at nice 19, as
``chip_smoke.py`` runs them, and torch's CPU threads set to ``threads``
meanwhile), then alone again, one line each, with the builds' count,
summed seconds and when the last one ended.
"""

import argparse
import tempfile
import time


def timed_phases(device) -> dict:
    """Seconds of phases 5, 7 and 9 of ``chip_smoke.py``, run in order."""
    import chip_smoke as cs

    out = {}
    t = time.time()
    _, _, mair = cs.phase_mair_path(device)
    out["MaIR path"] = time.time() - t
    t = time.time()
    _, _, unet = cs.phase_unet_path(device)
    out["MaIRUNet path"] = time.time() - t
    t = time.time()
    cs.phase_fused_path(device, mair, unet)
    out["fused route"] = time.time() - t
    return out


def report(label, secs, prebuilt=None):
    line = ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
    extra = f"; builds: {prebuilt.summary()}" if prebuilt is not None else ""
    print(f"{label}: {line}; sum {sum(secs.values()):.1f} s{extra}", flush=True)


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from tpuir_torch.ops import _kernels
    from tpuir_torch.utils.serving_mutants import NICE, Prebuilt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="4:8,2:6",
                    help="comma-separated jobs:threads, background builds at once and "
                         "torch's CPU threads beside them")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mutant_overlap: needs a CUDA card")
    print(cs.card_line(), flush=True)
    _kernels.build()
    device = torch.device("cuda", 0)
    threads = torch.get_num_threads()
    report(f"alone ({threads} threads)", timed_phases(device))
    for variant in args.variants.split(","):
        jobs, n = map(int, variant.split(":"))
        with tempfile.TemporaryDirectory(prefix="tpuir_mutant_overlap_") as root:
            prebuilt = Prebuilt(("K1", "mixer", "seq", "recur"), root, jobs=jobs)
            torch.set_num_threads(n)
            try:
                report(f"beside {jobs} builds ({' '.join(NICE)}), {n} threads",
                       timed_phases(device), prebuilt)
            finally:
                torch.set_num_threads(threads)
                prebuilt.close()
            print(f"  all {variant} builds: {prebuilt.summary()}", flush=True)
    report("alone again", timed_phases(device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

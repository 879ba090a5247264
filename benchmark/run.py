"""The benchmark of gem_tpu_torch on one NVIDIA card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  It loads, warms up, measures for
`--seconds`, checks what the timed path produced against the plain
reference, and prints one JSON line: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device` and, traced, `breakdown`; then `checks`, each
compared number beside its limit, which also end standard error.  Without
a card, or with fewer cards than the cell asks for, it exits 2 and prints
no result.
"""

import time

T_START = time.perf_counter()

from benchmark.host import pin_one_core  # noqa: E402

CORE = pin_one_core()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "benchmark_cache", sub)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, registry

    torch.set_num_threads(1)

    cell = registry.Benchmark(ROOT).cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", t_start=T_START)
    card = card_line()
    out["card"] = card
    checks = out.pop("checks")
    out["checks"] = checks
    print(f"card: {card}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

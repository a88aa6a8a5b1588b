"""Phase 14 of ``chip_smoke.py`` alone, with 14a's mixtral-8x22b at a
chosen depth.

    python tools/moe_tp_depth.py --layers 1

Builds the kernels, then runs ``chip_smoke.check_moe_tensor_parallel``
(14a-14d) with mixtral at ``--layers`` of its 56 layers (``chip_smoke.py``
runs it at ``MOE_TP_LAYERS``). Its log goes to standard output, 14a's
teacher-forced readings among it (``tp_teacher_gate``: the float32
distance of the sharded forward from one device's, the planted dropped
partial, the bf16 distance where no expert choice moved and where one
did); the script exits non-zero where a gate fails. Needs one NVIDIA GPU;
two ranks share it over gloo.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=1,
                    help="mixtral-8x22b's depth in 14a (default 1)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("moe_tp_depth: torch sees no CUDA device", file=sys.stderr)
        return 2
    # the spawned ranks unpickle chip_smoke's rank function by its module
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.kernels import _build

    torch.zeros(1, device="cuda")      # CUDA initialised before its stats
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.smi_line()
    chip_smoke.log(f"python {sys.version.split()[0]}, torch "
                   f"{torch.__version__}, cuda {torch.version.cuda}; {smi}")
    t0 = time.perf_counter()
    lib = _build.build()
    chip_smoke.log(f"built {lib.path.name} in {lib.seconds:.1f} s")
    chip_smoke.check_moe_tensor_parallel(torch, torch.device("cuda", 0),
                                         args.layers, smi)
    chip_smoke.log(f"phase 14 at {args.layers} layers: "
                   f"{time.perf_counter() - t0:.1f} s with the build ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

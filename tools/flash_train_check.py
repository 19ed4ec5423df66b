#!/usr/bin/env python3
"""A short card check of the flash kernels and the GPT training path.

Builds the kernels, prints the flash kernels' ptxas lines, runs
`chip_smoke.py`'s flash rows (the causal forward, the backward at the
gpt3_1p3b / llama1p3b shape and the small f32 rows, and both dropout
branches), then `train_llama.run_config("gpt3_1p3b")` for 1 warmup + 3
timed steps plus one profiled step with exact launch counts, and the GPT
card-against-CPU parity phase. One JSON line per row; the last line says
whether every gate held. It is the quick first call after a change to
either flash kernel; `chip_smoke.py` is the whole check.

    python3 tools/flash_train_check.py      # from the repository root; needs one CUDA card
"""
import json
import subprocess
import sys
import time

sys.path.insert(0, ".")

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from paddle_tpu_torch import _build  # noqa: E402


def main():
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _build.library()
    print(json.dumps(dict(build_s=time.perf_counter() - t0)))
    print("\n".join(l for l in C.ptxas_summary(_build.build_log() or "")
                    if "flash" in l))
    ok = True
    C.FLASH_BWD_CASES = C.FLASH_BWD_CASES[1:]
    for name, fn in (("flash_attention_fwd", C.check_flash),
                     ("flash_attention_bwd", C.check_flash_bwd),
                     ("fwd_dropout", C.check_flash_dropout),
                     ("bwd_dropout", C.check_flash_bwd_dropout)):
        for r in fn(torch, dev):
            print(json.dumps(dict(kernel=name, **r)), flush=True)
            ok &= r["ok"]
    runs, _ = C.train_path(torch, dev,
                           (("gpt3_1p3b", 1, 3, C.GPT_TRAIN_RUNS[0][3]),))
    for r in runs:
        print(json.dumps(r), flush=True)
        ok &= r["ok"]
    for r in C.gpt_train_parity(torch, dev):
        print(json.dumps(r), flush=True)
        ok &= r["ok"]
    print(json.dumps(dict(elapsed_s=time.perf_counter() - t0, ok=ok)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

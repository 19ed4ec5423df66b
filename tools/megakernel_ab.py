#!/usr/bin/env python3
"""Time the decode megakernel of several source trees on one card, in turns.

Each tree (a directory holding `chip_smoke.py` and `paddle_tpu_torch/`, for
example a parent commit unpacked with `git archive <commit> | tar -x -C
<dir>` into a git-ignored directory) runs in its own process, which builds
its kernels and prints one JSON line: the build's ptxas registers and
spills of the megakernel, `chip_smoke.check_megakernel`'s greedy rows
(bf16 and int8, ms and one "layer" launch's ms) and, where the tree has
them, `check_megakernel_topk`'s fold rows and `check_megakernel_verify`'s
speculative verify rows (tq = 4). The trees run in the order given, then
again in reverse, so drift on the card shows as a difference between a
tree's two rows.

    python3 tools/megakernel_ab.py chipwork/parent .     # needs one CUDA card
"""
import json
import subprocess
import sys

CHILD = r'''
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from paddle_tpu_torch import _build
t = time.perf_counter()
_build.library()
ptx = [l for l in cs.ptxas_summary(_build.build_log() or "") if "megakernel" in l]
dev = torch.device("cuda", 0)
out = dict(build_s=time.perf_counter() - t, ptxas=ptx, greedy=[], fold=[], verify=[])
for r in cs.check_megakernel(torch, dev):
    if "ms" in r:
        out["greedy"].append(dict(weights=r["weights"], ms=r["ms"],
                                  layer_ms=r["layer_ms"], ok=r["ok"]))
if hasattr(cs, "check_megakernel_topk"):
    for r in cs.check_megakernel_topk(torch, dev, ptx):
        if "ms" in r:
            out["fold"].append(dict(weights=r["weights"], R=r["R"], K=r["head_k"],
                                    ms=r["ms"], greedy_ms=r["greedy_ms"],
                                    library_ms=r["library_ms"], ok=r["ok"]))
if hasattr(cs, "check_megakernel_verify"):
    for r in cs.check_megakernel_verify(torch, dev, ptx):
        out["verify"].append(dict(weights=r["weights"], ms=r["ms"],
                                  sequential_ms=r["sequential_ms"], ok=r["ok"]))
print("RESULT " + json.dumps(out), flush=True)
'''


def main(trees):
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    ok = True
    for tree in list(trees) + list(reversed(trees)):
        p = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                           capture_output=True, text=True)
        line = next((ln for ln in p.stdout.splitlines()
                     if ln.startswith("RESULT ")), None)
        r = json.loads(line[7:]) if line else dict(error=p.stderr[-2000:])
        ok &= line is not None
        print(json.dumps(dict(tree=tree, **r)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

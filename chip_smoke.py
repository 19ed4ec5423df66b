#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (H100).

Phases, each printing one JSON line; any failure exits non-zero:
  1. device   the card's name and power limit; TF32 off
  2. build    nvcc builds every kernel under paddle_tpu_torch/csrc; the
              tensor-core builds' HMMA / HGMMA counts in cuobjdump's SASS
              (HGMMA in every instantiation of the wgmma flash forward)
  3. kernels  each kernel against its plain PyTorch version at the serving
              path's shapes (bf16), with times, bounds and library times;
              the causal flash forward on its wgmma build at the serving
              prefill's shape and at llama350m's and llama1p3b's training
              shapes, beside its f32 CUDA-core build;
              the ragged kernel's chunked prefill on its tensor-core build
              (the main row, a GQA group, page 16 at d 64 with an inactive
              slot, page 128) beside its per-page build's f32 row; the
              bf16 flash backward on its two tensor-core kernels, one
              launch's transient memory beside the f32 build's dQ
              partials;
              the decode megakernel at 7B width (one layer, a 2-layer whole
              step with the head, a constructed argmax tie; bf16 and int8)
              beside the op chain's time on the same inputs; its top-K
              fold (head_k 8 and 128, R 4 and 8, bf16 and int8) against a
              stable top-K of the greedy launch's logits, a cross-block
              tie, no logits buffer; the speculative verify entry of the
              ragged kernel (tq 4) against sequential decode steps bit for
              bit, and the megakernel's tq = 4 verify schedule (8 slots, a
              mixed write mask, bf16 and int8) against its plain version,
              the op chain's pools and 4 sequential tq = 1 launches (bit
              for bit); the flash kernels' dropout branch (p 0.1, forward
              and backward, gpt3_1p3b's shape in bf16, f32 rows) against
              the plain versions with the same seed, two launches with one
              seed bit-identical, dropout_p = 0 bit-equal to the causal
              launch; their mask and non-causal branches (BERT-base's
              shape with its [b, 1, 1, s] padding mask in bf16 and f32,
              no mask, [1, h, s, s] and [b, h, s, s] masks, a bool mask
              hiding a row, causal plus a mask, a mask with dropout, d 128)
              against the plain versions; a causal launch with a zero
              mask bit-equal to the causal launch, forward and backward;
              the megakernel's tensor-parallel segments (qkv / tail /
              down, tp 2 and 4 shards on the card, R 8 and 4, bf16 and
              int8, the greedy head, the top-8 fold, a tq = 4 verify
              pass) against their plain versions, and assembled bit for
              bit against the tp = 1 seg "full" launch
  4. path     LLaMA-7B (full width, all 32 layers, random weights from a
              seed) served through LLMEngine.generate(device_loop=True),
              bf16 and int8 weights, 12- and 300-token prompt batches;
              kernel launch counts, decode and prefill times
  5. parity   a 2-layer full-width model: the engine on the card (bf16,
              kernels) against the same weights on the CPU (f32, plain)
  6. cb_path  LLaMA-7B through ContinuousBatchingEngine (page 64, max_len
              1024, 8 slots, 128-token chunks, prefix cache): 12 ragged
              requests at decode_block 8 (bf16, int8) and 1 (bf16) on the
              op chain (megakernel=False), then through the megakernel
              ("multi" bf16 and int8, "layer" bf16, K=8), each stream
              twice, every prefill launch on the ragged kernel's
              tensor-core build; a single request with exact launch counts;
              a staggered stream (5 requests one step apart, prefills at
              slot widths 1-8, a shared prefix) at decode_block 8 and 4,
              cold and warm, unspeculated and at speculate=4, ids equal in
              each four (the op chain's rows do not depend on the block
              width); one
              steady-state stretch of fused blocks under torch.profiler
              (op chain and "multi") for the device's busy share;
              cb_sampled: the stream with greedy and sampled requests
              mixed ("multi" bf16 and int8 through the top-K fold, the op
              chain), each twice; proc: one request with a repetition
              penalty and a JSON-schema grammar over synthetic tokens;
              cb_spec: the stream at speculate=4 ("multi" with the n-gram
              and an oracle drafter, the op chain, and the sampled stream
              in "multi"), ids held against the unspeculated runs, tokens
              per verify pass, exact launch counts;
              tp_path: the stream through ContinuousBatchingEngine(tp=2)
              with both shards on the card ("multi" bf16 and int8, "layer"
              bf16, the op chain bf16 and int8, the sampled stream on
              "multi", the psum modes) held against the tp = 1 runs, exact
              launch counts, and LLMEngine(tp=2).generate(device_loop=True)
  7. cb_parity  the CB engine on the card (bf16, K=8, kernels; op chain and
              "multi") against the CPU CB engine (f32, plain versions), 2
              layers at 7B width, "multi" at speculate=4 (the CPU's
              spec ids equal its own stream) and "multi" at tp=2; cb_sampled_parity: the sampled "multi"
              stream (bf16 on the card) against the CPU's under the same
              margin rule
  8. train_path  SpmdTrainer.step through paddle_tpu_torch.train_llama at
              bench.py's two configs, full width and depth: llama350m (3
              warmup + 10 timed steps) and llama1p3b (2 + 5), then one
              step under torch.profiler; ms/step, tokens/s, MFU, peak
              memory, losses, exact launches per step, device time by
              kernel group and the busy share
  9. train_parity  the trainer on the card against the trainer on the CPU
              (f32), one carried-over state, 2 layers at the 350m width and
              vocab, bs 4, seq 256, 3 steps: card f32 (TF32 off) and card
              bf16
 10. gpt_train_path  train_llama.run_config("gpt3_1p3b"): full width and
              depth, dropout 0.1, 2 warmup + 5 timed steps and one
              profiled step; exact launches per step of both flash
              kernels and of their dropout branch; one keep-mask draw
 11. gpt_train_parity  train_parity on GPT: 2 layers at the gpt3_1p3b
              width and vocab, dropout on, each step keyed alike on both
              sides (the masks are the same bits)
 12. bert_train_path  paddle_tpu_torch.train_bert.run_bert("base"):
              BertForMaskedLM(BertConfig.base()) at full width and depth,
              batch 32 x 512 with a padding mask, dropout 0.1, AdamW; f32,
              then bf16 with multi_precision; 2 warmup + 5 timed steps and
              one profiled step each; exact launches per step (both flash
              kernels 12, every launch masked, non-causal, with dropout);
              losses falling
 13. bert_train_parity  2 layers at the base width, batch 4 x 128 with
              padding, 3 AdamW steps, dropout on: the card (f32, bf16)
              against the CPU (f32), the global generator seeded alike

Phase 3 also holds the ragged kernel at tq = 1 against the decode kernel
bit for bit (bf16 and f32, page 64 and page 8), a gate of the paged row:
tq = 1 and the verify entry stay on the per-page build for those bits.
The decode kernel and the per-page build run the walk `paged_route`
names (pages staged in shared memory, or read in place): the identity
cases also launch the direct walk on the same inputs and gate the staged
outputs equal to it, and the main paths' staged launches are gated equal
to the wrappers' launches. The paged rows add `paged_attention_dense` (a
dense [b, L, h, d] cache as identity-tabled pages) and report `device_ms`,
one launch's time in a replayed CUDA graph, beside `ms` (back-to-back
calls, which read the wrapper's host work where the kernel is shorter).
Every phase runs under a watchdog: one that does not finish in time ends
the run with a non-zero exit.
The line before the last holds {"kernels": [...]}, and the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py                 # needs one CUDA card
"""
import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
KERNEL_PHASE_S = 300          # watchdog limits: one kernel check, one path phase
PATH_PHASE_S = 900
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
CORE_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores

REPLACES = {
    "quantized_matmul": "paddle_tpu/ops/pallas/quantized_matmul.py:53",
    "paged_attention": "paddle_tpu/ops/pallas/paged_attention.py:39",
    "flash_attention_fwd": "paddle_tpu/ops/pallas/flash_attention.py:109",
    "ragged_paged_attention": "paddle_tpu/ops/pallas/paged_attention.py:211",
    "rms_norm": "paddle_tpu/ops/pallas/rms_norm.py:45",
    "flash_attention_bwd": "paddle_tpu/ops/pallas/flash_attention.py:430",
    "decode_megakernel": "paddle_tpu/ops/pallas/decode_megakernel.py:272",
    "decode_megakernel_topk": "paddle_tpu/ops/pallas/decode_megakernel.py:616",
    "spec_verify_attention": "paddle_tpu/ops/pallas/paged_attention.py:354",
    "decode_megakernel_verify": "paddle_tpu/ops/pallas/decode_megakernel.py:494",
    "flash_attention_fwd_dropout": "paddle_tpu/ops/pallas/flash_attention.py:160",
    "flash_attention_bwd_dropout": "paddle_tpu/ops/pallas/flash_attention.py:469",
    "flash_attention_fwd_masked": "paddle_tpu/ops/pallas/flash_attention.py:149",
    "flash_attention_bwd_masked": "paddle_tpu/ops/pallas/flash_attention.py:461",
    "decode_megakernel_tp": "paddle_tpu/ops/pallas/decode_megakernel.py:312",
    "ragged_paged_attention_tc": "paddle_tpu/ops/pallas/paged_attention.py:211",
    "flash_attention_bwd_tc": "paddle_tpu/ops/pallas/flash_attention.py:430",
    "flash_attention_bwd_f32": "paddle_tpu/ops/pallas/flash_attention.py:430",
    "flash_attention_fwd_tc": "paddle_tpu/ops/pallas/flash_attention.py:109",
    "flash_attention_fwd_f32": "paddle_tpu/ops/pallas/flash_attention.py:109",
    "paged_attention_staged": "paddle_tpu/ops/pallas/paged_attention.py:39",
    "spec_verify_attention_staged": "paddle_tpu/ops/pallas/paged_attention.py:354",
}
SOURCES = {
    "quantized_matmul": "paddle_tpu_torch/csrc/quantized_matmul.cu",
    "paged_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
    "flash_attention_fwd": "paddle_tpu_torch/csrc/flash_attention_tc.cu",
    "ragged_paged_attention": "paddle_tpu_torch/csrc/ragged_paged_attention_tc.cu",
    "rms_norm": "paddle_tpu_torch/csrc/rms_norm.cu",
    "flash_attention_bwd": "paddle_tpu_torch/csrc/flash_attention_bwd_tc.cu",
    "decode_megakernel": "paddle_tpu_torch/csrc/decode_megakernel.cu",
    "decode_megakernel_topk": "paddle_tpu_torch/csrc/decode_megakernel.cu",
    "spec_verify_attention": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
    "decode_megakernel_verify": "paddle_tpu_torch/csrc/decode_megakernel.cu",
    "flash_attention_fwd_dropout": "paddle_tpu_torch/csrc/flash_attention_tc.cu",
    "flash_attention_bwd_dropout": "paddle_tpu_torch/csrc/flash_attention_bwd_tc.cu",
    "flash_attention_fwd_masked": "paddle_tpu_torch/csrc/flash_attention_tc.cu",
    "flash_attention_bwd_masked": "paddle_tpu_torch/csrc/flash_attention_bwd_tc.cu",
    "decode_megakernel_tp": "paddle_tpu_torch/csrc/decode_megakernel_tp.cu",
    # the builds behind the entries: the chunked prefill's and the bf16
    # flash kernels' tensor-core builds (their main rows are the entries'),
    # and the f32 flash builds (their rows: BERT-base's f32 mask rows)
    "ragged_paged_attention_tc": "paddle_tpu_torch/csrc/ragged_paged_attention_tc.cu",
    "flash_attention_bwd_tc": "paddle_tpu_torch/csrc/flash_attention_bwd_tc.cu",
    "flash_attention_bwd_f32": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_fwd_tc": "paddle_tpu_torch/csrc/flash_attention_tc.cu",
    "flash_attention_fwd_f32": "paddle_tpu_torch/csrc/flash_attention.cu",
    # the staged walks of the decode kernel and of the ragged kernel's
    # per-page build (`paged_route`; the verify entry's main row), pages
    # staged in shared memory by bulk copies (`ptt::PageRing`, common.cuh)
    "paged_attention_staged": "paddle_tpu_torch/csrc/paged_attention.cu",
    "spec_verify_attention_staged": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
}



def emit(obj):
    print(json.dumps(obj), flush=True)


class watchdog:
    """Fails the run when a phase outlasts `seconds`: a kernel that never
    finishes (say a barrier whose bytes never land) would otherwise hold
    `torch.cuda.synchronize()` until the command's own limit. The process
    exits non-zero at once and prints no result."""

    def __init__(self, phase, seconds):
        self.phase, self.seconds = phase, seconds

    def _fire(self):
        import os
        print(f"chip_smoke: phase {self.phase} did not finish within {self.seconds} s",
              file=sys.stderr, flush=True)
        os._exit(1)

    def __enter__(self):
        import threading
        self.timer = threading.Timer(self.seconds, self._fire)
        self.timer.daemon = True
        self.timer.start()
        return self

    def __exit__(self, *exc):
        self.timer.cancel()
        return False


def bound_ms(n_bytes, flops, core_ops=0):
    """The least time for the work: bytes over the memory rate, or
    tensor-core flops over the bf16 peak plus operations that run outside
    the tensor cores (the dropout hash) over the CUDA cores' rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS_PER_S + core_ops / CORE_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, by CUDA events around `iters` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, launches=20, replays=10):
    """Device time of one fn() in ms with the host out of the way: fn()
    `launches` times captured in one CUDA graph, the graph replayed
    `replays` times between CUDA events. `time_ms` times back-to-back
    calls, so a call whose kernel takes less than the wrapper's host work
    reads the host's issue rate there."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def ptxas_summary(log):
    """One line per compiled kernel from nvcc's -Xptxas -v output: the
    kernel's name, its mangled template arguments (f = float,
    13__nv_bfloat16, Li128E = 128), registers and spilled bytes."""
    import re
    out, name, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN(\w+)'", ln)
        if m:
            rest = m.group(1)
            parts = []
            while len(parts) < 2:          # namespace, then the kernel
                k = re.match(r"(\d+)", rest)
                if not k:
                    break
                n = int(k.group(1))
                parts.append(rest[k.end():k.end() + n])
                rest = rest[k.end() + n:]
            name = (parts[-1] if parts else rest[:40]) + " " + rest[:rest.find("Ev")]
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs, {spill} B spilled")
            name = None
    return out


TC_KERNELS = ("ragged_tc_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel", "flash_fwd_tc_kernel")
# the kernels built on wgmma: HMMA alone (mma.sync) is not their design
WGMMA_KERNELS = ("flash_fwd_tc_kernel",)


def sass_mma_counts(lib_path, names=TC_KERNELS):
    """Tensor-core instructions in the built library's SASS (`cuobjdump
    -sass`): {mangled kernel name: {"HMMA": n, "HGMMA": n}} for every
    kernel whose name holds one of `names`."""
    import os
    import re
    import shutil
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(cuda, "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1) if any(n in m.group(1) for n in names) else None
            if cur:
                counts[cur] = {"HMMA": 0, "HGMMA": 0}
        elif cur and "HGMMA" in ln:
            counts[cur]["HGMMA"] += 1
        elif cur and "HMMA" in ln:
            counts[cur]["HMMA"] += 1
    return counts


def tc_sass_ok(counts):
    """Every tensor-core kernel is in the SASS, each with HMMA or HGMMA,
    and every instantiation of a wgmma kernel with HGMMA."""
    return (all(any(n in k for k in counts) for n in TC_KERNELS)
            and all(c["HMMA"] + c["HGMMA"] > 0 for c in counts.values())
            and all(c["HGMMA"] > 0 for k, c in counts.items()
                    if any(n in k for n in WGMMA_KERNELS)))


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- phase 3
def check_quantized_matmul(torch, dev):
    from paddle_tpu_torch.ops.pallas.quantized_matmul import (
        quantize_weights, quantized_matmul, quantized_matmul_reference)
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for m in (4, 4 * 320):
        for k, n in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)):
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            w = torch.randn((k, n), generator=g, device=dev) / math.sqrt(k)
            wq, sc = quantize_weights(w)
            del w
            got = quantized_matmul(x, wq, sc)
            ref = quantized_matmul_reference(x, wq, sc)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            # bf16 keeps 8 significant bits: two roundings of nearly equal
            # f32 sums differ by at most ~2^-8 of the output's magnitude
            tol = 1e-2 * float(ref.float().abs().max())
            ms = time_ms(torch, lambda: quantized_matmul(x, wq, sc))
            plain = time_ms(torch, lambda: quantized_matmul_reference(x, wq, sc),
                            iters=5)
            lib = None
            if hasattr(torch, "_weight_int8pack_mm"):
                w_nk = wq.t().contiguous()
                sc_b = sc.to(torch.bfloat16)
                try:
                    torch._weight_int8pack_mm(x, w_nk, sc_b)
                    torch.cuda.synchronize()
                except (RuntimeError, NotImplementedError):
                    lib = None     # this build has no CUDA kernel for it
                else:
                    lib = time_ms(torch, lambda: torch._weight_int8pack_mm(x, w_nk, sc_b))
                del w_nk
            bms, by = bound_ms(m * k * 2 + k * n + n * 4 + m * n * 2, 2 * m * n * k)
            rows.append(dict(m=m, k=k, n=n, max_abs_err=err, tol=tol, ok=err <= tol,
                             ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                             library_ms=lib))
            del x, wq, sc, got, ref
    # off the main path: ragged n and k (no 16-byte loads), the tiled path
    # on ragged edges, and f32 x (the GEMV path in chunks of 8 rows)
    for m, k, n, dt in ((3, 333, 100, torch.bfloat16), (40, 333, 100, torch.bfloat16),
                        (20, 4096, 4096, torch.float32)):
        x = torch.randn((m, k), generator=g, device=dev).to(dt)
        wq, sc = quantize_weights(torch.randn((k, n), generator=g, device=dev))
        got = quantized_matmul(x, wq, sc)
        ref = quantized_matmul_reference(x, wq, sc)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        # f32: the same sums in another order
        tol = (1e-2 if dt == torch.bfloat16 else 1e-4) * float(ref.float().abs().max())
        rows.append(dict(m=m, k=k, n=n, dtype=str(dt), max_abs_err=err, tol=tol,
                         ok=err <= tol))
    return rows


def paged_inputs(torch, dev, b, h, h_kv, d, p, lens, active, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    max_pages = 8
    n_pages = b * max_pages
    q = torch.randn((b, h, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((n_pages, p, h_kv, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((n_pages, p, h_kv, d), generator=g, device=dev).to(dtype)
    table = torch.randperm(n_pages, generator=g, device=dev).reshape(b, max_pages)
    table = table.to(torch.int32)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    act = torch.tensor(active, dtype=torch.int32, device=dev)
    return q, kp, vp, table, lens_t, act


def check_paged_attention(torch, dev):
    from paddle_tpu_torch.ops.pallas.paged_attention import (
        paged_attention, paged_attention_reference, paged_route, paged_stage_plan)
    rows = []
    # main path shape, then a GQA group and the tiny model's d = 16 (f32)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (("mha", 4, 32, 32, 128, 64, [300, 257, 311, 290], [1, 1, 1, 0], bf16),
             ("gqa rep=4", 4, 32, 8, 128, 64, [300, 1, 129, 64], [1, 1, 1, 1], bf16),
             ("d=16 f32", 3, 4, 4, 16, 16, [37, 0, 100], [1, 1, 1], f32))
    for name, b, h, h_kv, d, p, lens, active, dt in cases:
        q, kp, vp, table, lens_t, act = paged_inputs(torch, dev, b, h, h_kv, d, p,
                                                     lens, active, dt, seed=2)
        s0 = paged_attention.staged_launches
        got = paged_attention(q, kp, vp, table, lens_t, active=act)
        route = paged_route(dt, d, p)
        walk_counted = paged_attention.staged_launches - s0 == (route == "staged")
        ref = paged_attention_reference(q, kp, vp, table, lens_t, active=act)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        # outputs are convex mixes of N(0,1) rows: bf16 rounds at ~4e-3;
        # f32 differs only in the order of the sums
        tol = 1e-2 if dt == bf16 else 1e-4
        row = dict(case=name, b=b, h=h, h_kv=h_kv, d=d, p=p, lens=lens, active=active,
                   route=route, stages=paged_stage_plan(dt, d, p)[0],
                   walk_counted=walk_counted, max_abs_err=err, tol=tol,
                   ok=err <= tol and walk_counted)
        if name == "mha":
            row["ms"] = time_ms(torch, lambda: paged_attention(q, kp, vp, table, lens_t,
                                                               active=act))
            row["plain_ms"] = time_ms(torch, lambda: paged_attention_reference(
                q, kp, vp, table, lens_t, active=act), iters=5)
            live = sum(L for L, a in zip(lens, active) if a)
            n_bytes = (2 * b * h * d * 2 + live * h_kv * d * 2 * 2
                       + table.numel() * 4 + b * 8)
            row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 4 * live * h * d)
            row["library_ms"] = sdpa_paged_ms(torch, q[:, None], kp, vp, table,
                                              lens_t - 1, lens_t, act)
            row["library_call"] = LIBRARY_CALL
            row["device_ms"] = graph_ms(torch, lambda: paged_attention(
                q, kp, vp, table, lens_t, active=act))
            row["library_device_ms"] = sdpa_paged_ms(torch, q[:, None], kp, vp, table,
                                                     lens_t - 1, lens_t, act, graph_ms)
            # the ragged kernel at tq = 1, q_start = len - 1, against the
            # decode kernel: bit for bit (they share one per-page step);
            # and both staged walks against the direct walks
            tq1 = tq1_identity(torch, dev)
            row["ragged_tq1"] = tq1
            row["ragged_tq1_max_abs_diff"] = max(c["max_abs_diff"] for c in tq1)
            row["ragged_tq1_identical"] = all(c["identical"] for c in tq1)
            row["staged_equals_direct"] = all(c["staged_equals_direct"] for c in tq1)
            row["ok"] = (row["ok"] and row["ragged_tq1_identical"]
                         and row["staged_equals_direct"])
        rows.append(row)
    rows += check_paged_dense(torch, dev)
    return rows


def check_paged_dense(torch, dev):
    """`paged_attention_dense` (the decode kernel on a dense [b, L, h, d]
    cache viewed as identity-tabled pages) against the plain version on the
    same page view: the static engine's decode shape with [b] lengths and
    the default page (64: 128 does not divide L = 320), timed beside SDPA on
    the dense cache with a key-padding mask; a scalar length with an
    explicit page of 16."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.pallas.paged_attention import (
        paged_attention, paged_attention_dense, paged_attention_reference)
    rows = []
    b, L, h, d = 4, 320, 32, 128
    for name, seq_len, page in (("dense", [300, 257, 311, 290], None),
                                ("dense scalar len, page 16", 200, 16)):
        g = torch.Generator(device=dev).manual_seed(8)
        q = torch.randn((b, h, d), generator=g, device=dev).to(torch.bfloat16)
        kc, vc = (torch.randn((b, L, h, d), generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        p = page or 64
        lens = torch.tensor(seq_len, dtype=torch.int32, device=dev).expand(b)
        table = torch.arange(b * L // p, dtype=torch.int32, device=dev).reshape(b, L // p)
        n0 = paged_attention.launches
        got = paged_attention_dense(q, kc, vc, lens if page is None else seq_len,
                                    page_size=page)
        launched = paged_attention.launches - n0 == 1
        ref = paged_attention_reference(q, kc.reshape(-1, p, h, d), vc.reshape(-1, p, h, d),
                                        table, lens)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = 1e-2      # convex mixes of N(0,1) rows: bf16 rounds at ~4e-3
        row = dict(case=name, b=b, L=L, h=h, d=d, page=p, seq_len=seq_len,
                   launched=launched, max_abs_err=err, tol=tol, ok=err <= tol and launched)
        if page is None:
            row["ms"] = time_ms(torch, lambda: paged_attention_dense(q, kc, vc, lens))
            row["plain_ms"] = time_ms(torch, lambda: paged_attention_reference(
                q, kc.reshape(-1, p, h, d), vc.reshape(-1, p, h, d), table, lens), iters=5)
            live = int(lens.sum())
            n_bytes = 2 * b * h * d * 2 + live * h * d * 2 * 2 + b * 4
            row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 4 * live * h * d)
            qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
            mask = (torch.arange(L, device=dev)[None, :] < lens[:, None])[:, None, None]
            torch.cuda.synchronize()
            row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            row["device_ms"] = graph_ms(torch, lambda: paged_attention_dense(q, kc, vc, lens))
            row["library_device_ms"] = graph_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            row["library_call"] = ("torch.nn.functional.scaled_dot_product_attention on "
                                   "the dense cache (strided views) with a boolean "
                                   "key-padding mask")
        rows.append(row)
    return rows


def tq1_identity(torch, dev):
    """B5 at tq = 1 with q_start = len - 1 against B3 on the same inputs:
    bf16 and f32, page 64 and page 8, MHA and a GQA group of 4, ragged
    lengths (one inactive slot, one of length 1); and each kernel's staged
    walk against its direct walk (`stages` 0) on the same inputs."""
    from paddle_tpu_torch.ops.pallas import paged_attention as pa
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        for p in (64, 8):
            for h, h_kv in ((32, 32), (32, 8)):
                lens, active = [300, 257, 1, 290, 129], [1, 1, 1, 0, 1]
                b, d, mp = len(lens), 128, -(-max(lens) // p)
                g = torch.Generator(device=dev).manual_seed(5)
                q = torch.randn((b, h, d), generator=g, device=dev).to(dt)
                kp = torch.randn((b * mp, p, h_kv, d), generator=g, device=dev).to(dt)
                vp = torch.randn((b * mp, p, h_kv, d), generator=g, device=dev).to(dt)
                table = torch.randperm(b * mp, generator=g, device=dev)
                table = table.reshape(b, mp).to(torch.int32)
                ln = torch.tensor(lens, dtype=torch.int32, device=dev)
                ac = torch.tensor(active, dtype=torch.int32, device=dev)
                dec = pa.paged_attention(q, kp, vp, table, ln, active=ac)
                rag = pa.ragged_paged_attention(q[:, None], kp, vp, table, ln, ln - 1,
                                                active=ac)[:, 0]
                scale = 1.0 / math.sqrt(d)     # the wrappers' default
                dec_direct = pa._paged_launch(q, kp, vp, table, ln, scale, ac, 0)
                rag_direct = pa._ragged_launch(q[:, None], kp, vp, table, ln, ln - 1, ac,
                                               scale, 0)[:, 0]
                torch.cuda.synchronize()
                cases.append(dict(dtype=str(dt), page=p, h=h, h_kv=h_kv,
                                  route=pa.paged_route(dt, d, p),
                                  stages=pa.paged_stage_plan(dt, d, p)[0],
                                  max_abs_diff=max_err(rag, dec),
                                  identical=bool(torch.equal(rag, dec)),
                                  staged_equals_direct=bool(torch.equal(dec, dec_direct))
                                  and bool(torch.equal(rag, rag_direct))))
    return cases


LIBRARY_CALL = ("torch.nn.functional.scaled_dot_product_attention with a boolean mask, "
                "K/V gathered into contiguous form beforehand (the gather is not timed)")


def sdpa_paged_ms(torch, q, kp, vp, table, q_starts, ctx_lens, act, timer=time_ms):
    """Yardstick: one SDPA call on each slot's pages gathered beforehand
    (GQA heads expanded), masked causally at the ragged offsets, timed by
    `timer` (`time_ms`, or `graph_ms` for the device time alone)."""
    import torch.nn.functional as F
    b, tq, h, d = q.shape
    n_pages, p, h_kv, _ = kp.shape
    L = table.shape[1] * p
    idx = table.long().clamp(0, n_pages - 1)
    ks = kp[idx].reshape(b, L, h_kv, d).repeat_interleave(h // h_kv, 2)
    vs = vp[idx].reshape(b, L, h_kv, d).repeat_interleave(h // h_kv, 2)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, ks, vs))
    kpos = torch.arange(L, device=q.device)[None, None, None, :]
    qpos = (q_starts.long()[:, None] + torch.arange(tq, device=q.device))[:, None, :, None]
    mask = (kpos <= qpos) & (kpos < ctx_lens.long()[:, None, None, None])
    mask = mask & (act != 0)[:, None, None, None]
    torch.cuda.synchronize()
    return timer(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))


def ragged_inputs(torch, dev, b, tq, h, h_kv, d, p, max_pages, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = b * max_pages
    q = torch.randn((b, tq, h, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((n_pages, p, h_kv, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((n_pages, p, h_kv, d), generator=g, device=dev).to(dtype)
    table = torch.randperm(n_pages, generator=g, device=dev).reshape(b, max_pages)
    return q, kp, vp, table.to(torch.int32)


def check_ragged(torch, dev):
    from paddle_tpu_torch.ops.pallas.paged_attention import (
        paged_route, ragged_paged_attention, ragged_paged_attention_reference, ragged_route)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    # main path shape (8 slots, 128-token chunks at ragged offsets; slot 3
    # ends mid-chunk, slot 7 inactive), then a GQA group, then the tensor-core
    # build's other page sizes and d 64 (page 16 with a GQA group, a chunk
    # ending mid-page and an inactive slot; page 128), then the tiny model's
    # d = 16 in f32 (the per-page build)
    main_starts = [0, 128, 384, 640, 0, 256, 512, 0]
    cases = (("main", 8, 128, 32, 32, 128, 64, 16, main_starts,
              [128, 256, 512, 690, 128, 384, 640, 128], [1, 1, 1, 1, 1, 1, 1, 0], bf16),
             ("gqa rep=4", 4, 128, 32, 8, 128, 64, 16, [0, 200, 64, 700],
              [128, 328, 100, 828], [1, 1, 1, 1], bf16),
             ("page=16 d=64 rep=4", 4, 64, 8, 2, 64, 16, 40, [0, 100, 37, 500],
              [64, 164, 60, 530], [1, 1, 1, 0], bf16),
             ("page=128", 2, 128, 32, 32, 128, 128, 8, [0, 300], [128, 428], [1, 1], bf16),
             ("d=16 f32", 3, 8, 4, 2, 16, 8, 6, [0, 5, 23], [8, 13, 27], [1, 0, 1], f32))
    for name, b, tq, h, h_kv, d, p, mp, starts, ctx, active, dt in cases:
        q, kp, vp, table = ragged_inputs(torch, dev, b, tq, h, h_kv, d, p, mp, dt, seed=4)
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
        act = torch.tensor(active, dtype=torch.int32, device=dev)
        route = ragged_route("prefill", dt, d, p, tq)
        if route == "page":
            route += " " + paged_route(dt, d, p)
        tc0 = ragged_paged_attention.tc_launches
        s0 = ragged_paged_attention.staged_launches
        got = ragged_paged_attention(q, kp, vp, table, cl, st, active=act)
        tc_ran = (ragged_paged_attention.tc_launches - tc0 == (route == "tc")
                  and ragged_paged_attention.staged_launches - s0
                  == (route == "page staged"))
        ref = ragged_paged_attention_reference(q, kp, vp, table, cl, st, active=act)
        torch.cuda.synchronize()
        # rows past a slot's real chunk end are garbage by contract: compare
        # valid rows; inactive slots must be exact zeros; all rows finite
        err, zeros_ok = 0.0, True
        for i in range(b):
            n_valid = max(0, min(tq, ctx[i] - starts[i]))
            if not active[i]:
                zeros_ok &= bool((got[i] == 0).all())
            elif n_valid:
                err = max(err, max_err(got[i, :n_valid], ref[i, :n_valid]))
        finite = bool(torch.isfinite(got.float()).all())
        # convex mixes of N(0,1) rows: bf16 rounds at ~4e-3; f32 differs
        # only in the order of the sums
        tol = 1e-2 if dt == bf16 else 1e-4
        row = dict(case=name, b=b, tq=tq, h=h, h_kv=h_kv, d=d, p=p, max_pages=mp,
                   q_starts=starts, ctx_lens=ctx, active=active, route=route,
                   max_abs_err=err, tol=tol, inactive_zero=zeros_ok, finite=finite,
                   route_counted=tc_ran, ok=err <= tol and zeros_ok and finite and tc_ran)
        if name == "main":
            row["ms"] = time_ms(torch, lambda: ragged_paged_attention(q, kp, vp, table, cl, st,
                                                                      active=act))
            row["plain_ms"] = time_ms(torch, lambda: ragged_paged_attention_reference(
                q, kp, vp, table, cl, st, active=act), iters=5)
            row["library_ms"] = sdpa_paged_ms(torch, q, kp, vp, table, st, cl, act)
            row["library_call"] = LIBRARY_CALL
            # each input read once, each output written once: q and o, the
            # live keys/values of active slots, the table and the scalars;
            # operations: 4 d per (row, visible key) pair of active slots
            live = sum(c for c, a in zip(ctx, active) if a)
            pairs = sum(max(0, min(s0 + qi + 1, c)) for s0, c, a in zip(starts, ctx, active)
                        if a for qi in range(tq))
            n_bytes = (2 * b * tq * h * d * 2 + live * h_kv * d * 2 * 2
                       + table.numel() * 4 + 3 * b * 4)
            row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 4 * d * h * pairs)
        rows.append(row)
    return rows


# the causal forward's rows: the static engine's long-prompt prefill (the
# main row), the training shapes of llama350m (b32 s1024 h16 d64) and
# llama1p3b (b8 s1024 h16 d128), then a small f32 row
FLASH_CASES = ((4, 320, 300, 32, 128, "bfloat16"), (32, 1024, 1024, 16, 64, "bfloat16"),
               (8, 1024, 1024, 16, 128, "bfloat16"), (2, 130, 100, 2, 64, "float32"))


def check_flash(torch, dev):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.pallas.flash_attention import (
        flash_attention_fwd, flash_attention_reference, flash_fwd_route)
    rows = []
    for b, s, s_true, h, d, dt in FLASH_CASES:
        dt = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(3)
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        route = flash_fwd_route(dt, b, s, h, d)
        tc0 = flash_attention_fwd.tc_launches
        o, lse = flash_attention_fwd(q, k, v, True, scale, s_true=s_true)
        tc_ran = (flash_attention_fwd.tc_launches - tc0 == 1) == (route == "tc")
        o_ref, lse_ref = flash_attention_reference(q, k, v, True, scale, s_true=s_true)
        torch.cuda.synchronize()
        err = max_err(o, o_ref)
        lse_err = max_err(lse, lse_ref)
        # o: bf16 rounding (or, in f32, the order of the sums); lse is f32
        tol, lse_tol = (1e-2 if dt == torch.bfloat16 else 1e-4), 1e-3
        row = dict(b=b, s=s, s_true=s_true, h=h, d=d, dtype=str(dt), route=route,
                   route_launched=tc_ran, max_abs_err=err, tol=tol,
                   lse_max_abs_err=lse_err, lse_tol=lse_tol,
                   ok=err <= tol and lse_err <= lse_tol and tc_ran)
        del o, lse, o_ref, lse_ref
        if dt == torch.bfloat16:
            row["ms"] = time_ms(torch, lambda: flash_attention_fwd(q, k, v, True, scale,
                                                                   s_true=s_true))
            row["plain_ms"] = time_ms(torch, lambda: flash_attention_reference(
                q, k, v, True, scale, s_true=s_true), iters=5)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale))
            row["library_call"] = ("torch.nn.functional.scaled_dot_product_attention("
                                   "is_causal=True)" + ("" if s_true == s else
                                                        "; it attends to the padding keys too"))
            del qt, kt, vt
            pairs = sum(min(r + 1, s_true) for r in range(s))
            n_bytes = 4 * b * s * h * d * 2 + b * h * s * 4
            row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 4 * b * h * d * pairs)
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


# the training shapes of llama350m (32 x 1024 tokens, hidden 1024) and
# llama1p3b (8 x 1024, hidden 2048), then a small f32 row
RMS_CASES = ((32768, 1024, "bfloat16"), (8192, 2048, "bfloat16"),
             (1000, 1024, "float32"))
# the training shapes of llama350m (b32 s1024 h16 d64) and llama1p3b (b8
# s1024 h16 d128), then small f32 rows with s not a multiple of 64
FLASH_BWD_CASES = ((32, 1024, 16, 64, "bfloat16"), (8, 1024, 16, 128, "bfloat16"),
                   (2, 200, 2, 64, "float32"), (1, 130, 3, 128, "float32"))


def check_rms(torch, dev):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.pallas.rms_norm import rms_norm_fwd, rms_norm_reference
    bf16 = torch.bfloat16
    rows, eps = [], 1e-6
    for n, d, dt in RMS_CASES:
        dt = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(6)
        x = (2 * torch.randn((n, d), generator=g, device=dev)).to(dt)
        w = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).to(dt)
        y = rms_norm_fwd(x, w, eps)
        ref = rms_norm_reference(x, w, eps)
        torch.cuda.synchronize()
        err = max_err(y, ref)
        # both sides compute in f32 and round once: bf16 outputs differ by
        # at most one rounding (2^-8 relative); f32 by rsqrt's last bits
        tol = (2 ** -7 if dt == bf16 else 1e-5) * float(ref.float().abs().max())
        row = dict(n=n, d=d, dtype=str(dt), max_abs_err=err, tol=tol, ok=err <= tol)
        if dt == bf16:
            row["ms"] = time_ms(torch, lambda: rms_norm_fwd(x, w, eps))
            row["plain_ms"] = time_ms(torch, lambda: rms_norm_reference(x, w, eps), iters=5)
            row["library_ms"] = time_ms(torch, lambda: F.rms_norm(x, (d,), w, eps))
            row["library_call"] = "torch.nn.functional.rms_norm"
            es = x.element_size()
            row["bound_ms"], row["bound_by"] = bound_ms(2 * n * d * es + d * es, 4 * n * d)
        rows.append(row)
    return rows


def check_flash_bwd(torch, dev):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.pallas.flash_attention import (
        BWD_TILE, flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd,
        flash_bwd_route)
    bf16 = torch.bfloat16
    rows = []
    for b, s, h, d, dt in FLASH_BWD_CASES:
        dt = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(7)
        q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt)
                       for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        o, lse = flash_attention_fwd(q, k, v, True, scale)
        route, part_shape = flash_bwd_route(dt, b, s, h, d)
        # one launch's transient memory (everything it allocates, outputs
        # included) beside the per-key-tile dQ partials the f32 build
        # allocates, [ceil(s / 64), b, s, h, d] f32
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        got = flash_attention_bwd(q, k, v, o, lse, do, True, scale)
        torch.cuda.synchronize()
        launch_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
        partial_gb = 4 * -(-s // BWD_TILE) * b * s * h * d / 1e9
        ref = flash_attention_bwd_reference(q, k, v, o, lse, do, True, scale)
        torch.cuda.synchronize()
        errs = {n: max_err(a, r) for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
        # per gradient, relative to its largest entry: bf16 rounds the
        # output once (2^-8) after f32 sums; f32 differs in sum order only
        rel = 1e-2 if dt == bf16 else 1e-4
        tols = {n: rel * float(r.float().abs().max()) for n, r in zip(("dq", "dk", "dv"), ref)}
        del got, ref
        # the bf16 build allocates no partial buffer: its launch's whole
        # transient stays below the partials' size
        no_partial = part_shape is None and launch_gb < partial_gb
        row = dict(b=b, s=s, h=h, d=d, dtype=str(dt), route=route,
                   max_abs_err=max(errs.values()), max_abs_err_by_grad=errs,
                   tol_by_grad=tols, launch_peak_gb=launch_gb,
                   f32_build_partial_gb=partial_gb,
                   ok=all(errs[n] <= tols[n] for n in errs)
                   and (no_partial if dt == bf16 else part_shape is not None))
        if dt == bf16:
            row["ms"] = time_ms(torch, lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                                   True, scale), iters=5)
            row["plain_ms"] = time_ms(torch, lambda: flash_attention_bwd_reference(
                q, k, v, o, lse, do, True, scale), iters=2, warmup=1)
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                          for x in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale)
            dot = do.transpose(1, 2).contiguous()
            row["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True), iters=5)
            row["library_call"] = ("the backward alone of torch.nn.functional."
                                   "scaled_dot_product_attention(is_causal=True)")
            del qt, kt, vt, out, dot
            # q, k, v, o, dO read and dQ, dK, dV written once, lse read;
            # 10 d flops per visible (query, key) pair
            pairs = b * h * s * (s + 1) // 2
            n_bytes = 8 * b * s * h * d * q.element_size() + b * h * s * 4
            row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 10 * d * pairs)
        rows.append(row)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rows


# the gpt3_1p3b training shape (b8 s1024 h16 d128) in bf16, then f32 at a
# smaller b (d 128, and d 64 with s not a multiple of 64)
DROPOUT_P, DROPOUT_SEED = 0.1, 1234567
FLASH_DROPOUT_CASES = ((8, 1024, 16, 128, "bfloat16"), (2, 1024, 16, 128, "float32"),
                       (2, 200, 3, 64, "float32"))
HASH_OPS = 16     # integer operations of one keep bit (`ptt::dropout_keep`)


def _same(torch, a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_flash_dropout(torch, dev):
    """The forward's dropout branch against its plain version with the
    same seed; two launches with one seed bit-identical; lse bit-equal to
    the launch without dropout (lse is the logsumexp before dropout); a
    launch with dropout_p = 0 bit-equal to the causal launch."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.pallas.flash_attention import (
        flash_attention_fwd, flash_attention_reference)
    p, seed = DROPOUT_P, DROPOUT_SEED
    rows = []
    for b, s, h, d, dt in FLASH_DROPOUT_CASES:
        dt = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(8)
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        got = flash_attention_fwd(q, k, v, True, scale, None, p, seed)
        again = flash_attention_fwd(q, k, v, True, scale, None, p, seed)
        p0 = flash_attention_fwd(q, k, v, True, scale, None, 0.0)
        causal = flash_attention_fwd(q, k, v, True, scale)
        ref = flash_attention_reference(q, k, v, True, scale, None, p, seed)
        torch.cuda.synchronize()
        err, lse_err = max_err(got[0], ref[0]), max_err(got[1], ref[1])
        # o: one bf16 rounding of nearly equal f32 sums (2^-7 of the
        # largest output), in f32 the order of the sums; lse is f32
        tol = (2 ** -7 if dt == torch.bfloat16 else 1e-5) * float(ref[0].float().abs().max())
        lse_tol = 1e-3
        row = dict(b=b, s=s, h=h, d=d, dtype=str(dt), dropout_p=p, seed=seed,
                   max_abs_err=err, tol=tol, lse_max_abs_err=lse_err, lse_tol=lse_tol,
                   repeat_identical=_same(torch, got, again),
                   p0_equals_causal=_same(torch, p0, causal),
                   lse_equals_no_dropout=torch.equal(got[1], causal[1]),
                   dropped=not torch.equal(got[0], causal[0]))
        row["ok"] = (err <= tol and lse_err <= lse_tol and row["repeat_identical"]
                     and row["p0_equals_causal"] and row["lse_equals_no_dropout"]
                     and row["dropped"])
        del again, p0, causal, ref
        if dt == torch.bfloat16:
            row["ms"] = time_ms(torch, lambda: flash_attention_fwd(q, k, v, True, scale,
                                                                   None, p, seed))
            row["no_dropout_ms"] = time_ms(torch, lambda: flash_attention_fwd(
                q, k, v, True, scale))
            row["plain_ms"] = time_ms(torch, lambda: flash_attention_reference(
                q, k, v, True, scale, None, p, seed), iters=3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, dropout_p=p, is_causal=True, scale=scale))
            row["library_call"] = ("torch.nn.functional.scaled_dot_product_attention("
                                   "dropout_p=0.1, is_causal=True); its RNG differs")
            del qt, kt, vt
            # q, k, v read and o written once, lse written; 4 d flops and
            # one keep bit per visible (query, key) pair
            pairs = b * h * s * (s + 1) // 2
            row["bound_ms"], row["bound_by"] = bound_ms(
                4 * b * s * h * d * q.element_size() + b * h * s * 4, 4 * d * pairs,
                HASH_OPS * pairs)
        rows.append(row)
        del q, k, v, got
        torch.cuda.empty_cache()
    return rows


def check_flash_bwd_dropout(torch, dev):
    """The backward's dropout branch against its plain version with the
    same seed, from the kernel forward's o and lse; two launches with one
    seed bit-identical; dropout_p = 0 bit-equal to the causal launch."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.pallas.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd)
    p, seed = DROPOUT_P, DROPOUT_SEED
    bf16 = torch.bfloat16
    rows = []
    for b, s, h, d, dt in FLASH_DROPOUT_CASES:
        dt = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(9)
        q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt)
                       for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        o, lse = flash_attention_fwd(q, k, v, True, scale, None, p, seed)
        got = flash_attention_bwd(q, k, v, o, lse, do, True, scale, None, None, p, seed)
        again = flash_attention_bwd(q, k, v, o, lse, do, True, scale, None, None, p, seed)
        p0 = flash_attention_bwd(q, k, v, o, lse, do, True, scale, None, None, 0.0)
        causal = flash_attention_bwd(q, k, v, o, lse, do, True, scale)
        ref = flash_attention_bwd_reference(q, k, v, o, lse, do, True, scale, None, p, seed)
        torch.cuda.synchronize()
        errs = {n: max_err(a, r) for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
        # per gradient, relative to its largest entry: bf16 rounds the
        # output once (2^-8) after f32 sums; f32 differs in sum order only
        rel = 1e-2 if dt == bf16 else 1e-4
        tols = {n: rel * float(r.float().abs().max()) for n, r in zip(("dq", "dk", "dv"), ref)}
        row = dict(b=b, s=s, h=h, d=d, dtype=str(dt), dropout_p=p, seed=seed,
                   max_abs_err=max(errs.values()), max_abs_err_by_grad=errs,
                   tol_by_grad=tols, repeat_identical=_same(torch, got, again),
                   p0_equals_causal=_same(torch, p0, causal))
        row["ok"] = (all(errs[n] <= tols[n] for n in errs) and row["repeat_identical"]
                     and row["p0_equals_causal"])
        del got, again, p0, causal, ref
        torch.cuda.empty_cache()
        if dt == bf16:
            row["ms"] = time_ms(torch, lambda: flash_attention_bwd(
                q, k, v, o, lse, do, True, scale, None, None, p, seed), iters=5)
            row["no_dropout_ms"] = time_ms(torch, lambda: flash_attention_bwd(
                q, k, v, o, lse, do, True, scale), iters=5)
            row["plain_ms"] = time_ms(torch, lambda: flash_attention_bwd_reference(
                q, k, v, o, lse, do, True, scale, None, p, seed), iters=2, warmup=1)
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                          for x in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, dropout_p=p, is_causal=True,
                                                 scale=scale)
            dot = do.transpose(1, 2).contiguous()
            row["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True), iters=5)
            row["library_call"] = ("the backward alone of torch.nn.functional."
                                   "scaled_dot_product_attention(dropout_p=0.1, "
                                   "is_causal=True); its RNG differs")
            del qt, kt, vt, out, dot
            # q, k, v, o, dO read and dQ, dK, dV written once, lse read;
            # 10 d flops and one keep bit per visible (query, key) pair
            pairs = b * h * s * (s + 1) // 2
            row["bound_ms"], row["bound_by"] = bound_ms(
                8 * b * s * h * d * q.element_size() + b * h * s * 4, 10 * d * pairs,
                HASH_OPS * pairs)
        rows.append(row)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 3 (masks)
# BertConfig.base()'s attention (b 32, s 512, h 12, d 64) with its [b, 1, 1,
# s] key-padding mask (true lengths from RandomState(0) in [128, 512], -1e9
# past them, in the activations' dtype), bf16 and f32; then the other mask
# layouts, a bool mask hiding one row entirely (s 200: a ragged last tile),
# causal plus a mask, the mask with dropout 0.1, and d 128
MASK_CASES = (
    # name, b, s, h, d, dtype, mask kind, causal, dropout_p
    ("bert_base", 32, 512, 12, 64, "bfloat16", "key_padding", False, 0.0),
    ("bert_base_f32", 32, 512, 12, 64, "float32", "key_padding", False, 0.0),
    ("bert_base_dropout", 32, 512, 12, 64, "bfloat16", "key_padding", False, 0.1),
    ("noncausal_no_mask", 32, 512, 12, 64, "bfloat16", None, False, 0.0),
    ("head_mask_1hss", 4, 512, 12, 64, "bfloat16", "head", False, 0.0),
    ("full_mask_bhss", 4, 512, 12, 64, "bfloat16", "full", False, 0.0),
    ("bool_hidden_row", 2, 200, 3, 64, "float32", "bool_hidden_row", False, 0.0),
    ("causal_mask", 4, 512, 12, 64, "bfloat16", "key_padding", True, 0.0),
    ("d128_mask_dropout", 2, 300, 4, 128, "float32", "key_padding", False, 0.1),
)
MASK_SEED = 2468


def make_mask(torch, dev, kind, b, s, h, dtype, g):
    """The case's mask: additive in `dtype`, or bool for the hidden row."""
    import numpy as np
    if kind is None:
        return None
    if kind == "key_padding":
        lens = np.random.RandomState(0).randint(min(128, s), s + 1, size=b)
        real = torch.arange(s, device=dev)[None, :] < torch.as_tensor(lens, device=dev)[:, None]
        return torch.where(real, 0.0, -1e9).to(dtype)[:, None, None, :]
    if kind in ("head", "full"):
        return torch.randn((1 if kind == "head" else b, h, s, s), generator=g,
                           device=dev).to(dtype)
    m = torch.rand((b, 1, s, s), generator=g, device=dev) > 0.3
    m[..., 0] = True
    m[0, 0, 5, :] = False          # batch 0, row 5: every key hidden
    return m


def library_mask(torch, mask, causal, dtype):
    """The same mask as SDPA takes it ([b|1, h|1, s, s] broadcastable, in
    q's dtype), the causal triangle folded in."""
    if mask is None:
        return None
    m = torch.where(mask, 0.0, -1e30).to(dtype) if mask.dtype == torch.bool else mask
    if causal:
        s = m.shape[-1]
        tri = torch.ones((s, s), dtype=torch.bool, device=m.device).tril()
        m = m + torch.where(tri, 0.0, -1e30).to(dtype)
    return m


def _visible_pairs(b, h, s, causal):
    return b * h * (s * (s + 1) // 2 if causal else s * s)


def check_flash_masked(torch, dev):
    """The forward's mask and non-causal branches against the plain
    version on the same inputs and mask; mask with dropout: two launches
    with one seed bit-identical."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.pallas.flash_attention import (
        flash_attention_fwd, flash_attention_reference)
    rows = []
    for name, b, s, h, d, dt, kind, causal, p in MASK_CASES:
        dt = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(11)
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt)
                   for _ in range(3))
        mask = make_mask(torch, dev, kind, b, s, h, dt, g)
        scale = 1.0 / math.sqrt(d)
        seed = MASK_SEED if p > 0 else None
        args = (q, k, v, causal, scale, None, p, seed, mask)
        got = flash_attention_fwd(*args)
        ref = flash_attention_reference(*args)
        torch.cuda.synchronize()
        err, lse_err = max_err(got[0], ref[0]), max_err(got[1], ref[1])
        # o: one bf16 rounding of nearly equal f32 sums (2^-7 of the
        # largest output), in f32 the order of the sums; lse is f32
        tol = (2 ** -7 if dt == torch.bfloat16 else 1e-5) * float(ref[0].float().abs().max())
        lse_tol = 1e-3
        row = dict(case=name, b=b, s=s, h=h, d=d, dtype=str(dt), mask=kind,
                   mask_shape=None if mask is None else list(mask.shape), causal=causal,
                   dropout_p=p, max_abs_err=err, tol=tol, lse_max_abs_err=lse_err,
                   lse_tol=lse_tol, finite=bool(torch.isfinite(got[0]).all()))
        row["ok"] = err <= tol and lse_err <= lse_tol and row["finite"]
        if p > 0:
            again = flash_attention_fwd(*args)
            row["repeat_identical"] = _same(torch, got, again)
            row["ok"] &= row["repeat_identical"]
            del again
        del got, ref
        row["ms"] = time_ms(torch, lambda: flash_attention_fwd(*args), iters=10)
        row["plain_ms"] = time_ms(torch, lambda: flash_attention_reference(*args),
                                  iters=2, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lm = library_mask(torch, mask, causal, dt)
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=lm, dropout_p=p, scale=scale), iters=10)
        row["library_call"] = ("torch.nn.functional.scaled_dot_product_attention with the "
                               "same mask (causal folded into it)"
                               + ("; its RNG differs" if p > 0 else ""))
        del qt, kt, vt, lm
        # q, k, v and the mask read and o written once, lse written; 4 d
        # flops (and with dropout one keep bit) per visible pair
        pairs = _visible_pairs(b, h, s, causal)
        mbytes = 0 if mask is None else mask.numel() * mask.element_size()
        row["bound_ms"], row["bound_by"] = bound_ms(
            4 * b * s * h * d * q.element_size() + b * h * s * 4 + mbytes, 4 * d * pairs,
            HASH_OPS * pairs if p > 0 else 0)
        rows.append(row)
        del q, k, v, mask
        torch.cuda.empty_cache()
    return rows


def check_flash_bwd_masked(torch, dev):
    """The backward's mask and non-causal branches against the plain
    version, from the kernel forward's o and lse; mask with dropout: two
    launches with one seed bit-identical."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.pallas.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd)
    bf16 = torch.bfloat16
    rows = []
    for name, b, s, h, d, dt, kind, causal, p in MASK_CASES:
        dt = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(12)
        q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt)
                       for _ in range(4))
        mask = make_mask(torch, dev, kind, b, s, h, dt, g)
        scale = 1.0 / math.sqrt(d)
        seed = MASK_SEED if p > 0 else None
        o, lse = flash_attention_fwd(q, k, v, causal, scale, None, p, seed, mask)
        kargs = (q, k, v, o, lse, do, causal, scale, None, mask, p, seed)
        got = flash_attention_bwd(*kargs)
        ref = flash_attention_bwd_reference(q, k, v, o, lse, do, causal, scale, None, p,
                                            seed, mask)
        torch.cuda.synchronize()
        errs = {n: max_err(a, r) for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
        # per gradient, relative to its largest entry: bf16 rounds the
        # output once (2^-8) after f32 sums; f32 differs in sum order only
        rel = 1e-2 if dt == bf16 else 1e-4
        tols = {n: rel * float(r.float().abs().max()) for n, r in zip(("dq", "dk", "dv"), ref)}
        row = dict(case=name, b=b, s=s, h=h, d=d, dtype=str(dt), mask=kind,
                   mask_shape=None if mask is None else list(mask.shape), causal=causal,
                   dropout_p=p, max_abs_err=max(errs.values()), max_abs_err_by_grad=errs,
                   tol_by_grad=tols, finite=all(bool(torch.isfinite(x).all()) for x in got))
        row["ok"] = all(errs[n] <= tols[n] for n in errs) and row["finite"]
        if p > 0:
            again = flash_attention_bwd(*kargs)
            row["repeat_identical"] = _same(torch, got, again)
            row["ok"] &= row["repeat_identical"]
            del again
        del got, ref
        torch.cuda.empty_cache()
        row["ms"] = time_ms(torch, lambda: flash_attention_bwd(*kargs), iters=5)
        row["plain_ms"] = time_ms(torch, lambda: flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal, scale, None, p, seed, mask), iters=2, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
        lm = library_mask(torch, mask, causal, dt)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lm, dropout_p=p,
                                             scale=scale)
        dot = do.transpose(1, 2).contiguous()
        row["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), iters=5)
        row["library_call"] = ("the backward alone of torch.nn.functional."
                               "scaled_dot_product_attention with the same mask"
                               + ("; its RNG differs" if p > 0 else ""))
        del qt, kt, vt, out, dot, lm
        # q, k, v, o, dO and the mask read, dQ, dK, dV written once, lse
        # read; 2.5 x the forward's flops (10 d per visible pair)
        pairs = _visible_pairs(b, h, s, causal)
        mbytes = 0 if mask is None else mask.numel() * mask.element_size()
        row["bound_ms"], row["bound_by"] = bound_ms(
            8 * b * s * h * d * q.element_size() + b * h * s * 4 + mbytes, 10 * d * pairs,
            HASH_OPS * pairs if p > 0 else 0)
        rows.append(row)
        del q, k, v, do, o, lse, mask
        torch.cuda.empty_cache()
    return rows


def flash_mask_gates(torch, dev):
    """Bit gates of the mask branch: a causal launch with an all-zero
    additive mask equals the causal launch without one (x + 0.0 is exact;
    the mask launch's extra tiles add exact zeros), forward and backward;
    with dropout_p = 0 the masked-dropout call equals the masked launch."""
    from paddle_tpu_torch.ops.pallas.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    rows = []
    for b, s, h, d, dt in ((4, 512, 12, 64, torch.bfloat16), (2, 300, 4, 128, torch.float32)):
        g = torch.Generator(device=dev).manual_seed(13)
        q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt)
                       for _ in range(4))
        zero = torch.zeros((b, 1, 1, s), dtype=dt, device=dev)
        pad = make_mask(torch, dev, "key_padding", b, s, h, dt, g)
        base = flash_attention_fwd(q, k, v, True)
        zfwd = flash_attention_fwd(q, k, v, True, mask=zero)
        gb = flash_attention_bwd(q, k, v, *base, do, True)
        gz = flash_attention_bwd(q, k, v, *base, do, True, mask=zero)
        masked = flash_attention_fwd(q, k, v, False, mask=pad)
        p0 = flash_attention_fwd(q, k, v, False, None, None, 0.0, MASK_SEED, pad)
        mb = flash_attention_bwd(q, k, v, *masked, do, False, mask=pad)
        mb0 = flash_attention_bwd(q, k, v, *masked, do, False, None, None, pad, 0.0, MASK_SEED)
        torch.cuda.synchronize()
        row = dict(b=b, s=s, h=h, d=d, dtype=str(dt),
                   causal_zero_mask_equals_causal_fwd=_same(torch, zfwd, base),
                   causal_zero_mask_equals_causal_bwd=_same(torch, gz, gb),
                   p0_equals_masked_fwd=_same(torch, p0, masked),
                   p0_equals_masked_bwd=_same(torch, mb0, mb))
        row["ok"] = all(v for k_, v in row.items() if k_.endswith(("_fwd", "_bwd")))
        rows.append(row)
        del q, k, v, do, base, zfwd, gb, gz, masked, p0, mb, mb0
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 3 (B6)
MK_LENS, MK_ACTIVE = [300, 257, 311, 290], [1, 1, 1, 0]
MK_TIE = (5, 20, 31000)   # one 32-column slab, then another slab and block


def megakernel_inputs(torch, dev, eng, seed):
    """One decode step's inputs for a 4-slot engine: N(0, 1) pools in every
    layer, a random page table, lens 300/257/311/290 with the last slot
    inactive, and random tokens."""
    g = torch.Generator(device=dev).manual_seed(seed)
    for f in eng._k_flat + eng._v_flat:
        f.copy_(torch.randn(f.shape, generator=g, device=dev))
    mp = eng.max_pages_per_seq
    table = torch.randperm(eng.n_pages, generator=g, device=dev)[:4 * mp]
    table = table.reshape(4, mp).to(torch.int32)
    lens = torch.tensor(MK_LENS, dtype=torch.int32, device=dev)
    act = torch.tensor(MK_ACTIVE, dtype=torch.int32, device=dev)
    tok = torch.randint(0, eng.cfg.vocab_size, (4,), generator=g, device=dev)
    return tok, table, lens, act


def clone_pack(pack):
    """The same weights over copies of the pools (the plain version's)."""
    from paddle_tpu_torch.ops.pallas.decode_megakernel import MegakernelPack
    return MegakernelPack(
        pack.layers, [f.clone() for f in pack.k_flat], [f.clone() for f in pack.v_flat],
        pack.cos, pack.sin, nh=pack.nh, nh_kv=pack.nh_kv, hd=pack.hd, eps=pack.eps,
        page_size=pack.page_size, norm=pack.norm, head=pack.head)


def written_rows(pack, table, lens, act):
    rows = [int(table[i, int(L) // pack.page_size]) * pack.page_size + int(L) % pack.page_size
            for i, (L, a) in enumerate(zip(lens.tolist(), act.tolist())) if a]
    return rows + [pack.oob]


def pools_diff(pack_a, pack_b, rows, layers):
    """(max abs diff of the written rows, True when every other row of every
    layer is equal bit for bit)."""
    import torch
    err, same = 0.0, True
    for li in range(pack_a.n_layers):
        for fa, fb in ((pack_a.k_flat[li], pack_b.k_flat[li]),
                       (pack_a.v_flat[li], pack_b.v_flat[li])):
            mask = torch.ones(fa.shape[0], dtype=torch.bool, device=fa.device)
            if li in layers:
                mask[rows] = False
                err = max(err, max_err(fa[rows[:-1]], fb[rows[:-1]]))
            same &= bool(torch.equal(fa[mask], fb[mask]))
    return err, same


def set_tie(torch, pack, xn):
    """Make head columns MK_TIE identical and the largest logit of every
    row: each becomes the direction of the rows' normed final hidden."""
    d = xn.float().sum(0)
    d = d / d.norm()
    if isinstance(pack.head, tuple):
        wq, sc = pack.head
        col = torch.round(127 * d / d.abs().max()).to(torch.int8)
        for c in MK_TIE:
            wq[:, c] = col
            sc[c] = 0.05
    else:
        for c in MK_TIE:
            pack.head[:, c] = (8 * d).to(pack.head.dtype)


def megakernel_f32_rows(torch, dev):
    """Off the main path (the engine computes in bf16 on the card): f32
    activations with dense f32 and with int8 weights, a small GQA width (4
    heads over 2, d 64, hidden 256, ffn 512, vocab 1000, page 16), 2 layers
    and the head, 3 slots with lens 37/0/100 and the last inactive."""
    from paddle_tpu_torch.models.llama import _rope_cache
    from paddle_tpu_torch.ops.pallas.decode_megakernel import (
        MegakernelPack, decode_megakernel, decode_megakernel_reference)
    from paddle_tpu_torch.ops.pallas.quantized_matmul import quantize_weights
    H, nh, nh_kv, hd, F, V, p, max_len = 256, 4, 2, 64, 512, 1000, 16, 128
    lens_l, act_l = [37, 0, 100], [1, 1, 0]
    R, mp = len(lens_l), max_len // p
    rows = []
    for quant in (False, True):
        g = torch.Generator(device=dev).manual_seed(13)

        def w(k, n):
            t = torch.randn((k, n), generator=g, device=dev) / math.sqrt(k)
            return quantize_weights(t) if quant else t

        layers = [dict(ln1=1 + 0.1 * torch.randn((H,), generator=g, device=dev),
                       ln2=1 + 0.1 * torch.randn((H,), generator=g, device=dev),
                       wq=w(H, nh * hd), wk=w(H, nh_kv * hd), wv=w(H, nh_kv * hd),
                       wo=w(nh * hd, H), wg=w(H, F), wu=w(H, F), wd=w(F, H))
                  for _ in range(2)]
        n_pages = R * mp
        flat = [torch.randn((n_pages * p + 1, nh_kv, hd), generator=g, device=dev)
                for _ in range(4)]
        cos, sin = _rope_cache(max_len, hd, 10000.0, device=dev)
        pack = MegakernelPack(layers, flat[:2], flat[2:], cos, sin, nh=nh, nh_kv=nh_kv,
                              hd=hd, eps=1e-6, page_size=p,
                              norm=1 + 0.1 * torch.randn((H,), generator=g, device=dev),
                              head=w(H, V))
        ref = clone_pack(pack)
        table = torch.randperm(n_pages, generator=g, device=dev).reshape(R, mp)
        table = table.to(torch.int32)
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        act = torch.tensor(act_l, dtype=torch.int32, device=dev)
        h0 = torch.randn((R, H), generator=g, device=dev)
        hk, tk, _, lk = decode_megakernel(h0.clone(), pack, table, lens, act, head=True)
        hr, tr, _, lr = decode_megakernel_reference(h0.clone(), ref, table, lens, act,
                                                    head=True)
        torch.cuda.synchronize()
        err_kv, untouched = pools_diff(pack, ref, written_rows(pack, table, lens, act),
                                       layers=(0, 1))
        # f32: the same sums in other orders
        tol = {n: 1e-4 * float(r.abs().max()) for n, r in (("h", hr), ("logits", lr))}
        top2 = torch.topk(lr, 2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 1e-3
        errs = dict(h=max_err(hk, hr), kv=err_kv, logits=max_err(lk, lr))
        rows.append(dict(case="f32 int8" if quant else "f32 dense", R=R, lens=lens_l,
                         active=act_l, max_abs_err=max(errs.values()), errs=errs, tol=tol,
                         untouched_rows_equal=untouched,
                         tok_equal_where_decided=bool((tk == tr)[decided].all()),
                         ok=(errs["h"] <= tol["h"] and errs["kv"] <= tol["h"]
                             and errs["logits"] <= tol["logits"] and untouched
                             and bool((tk == tr)[decided].all()))))
    return rows


def check_megakernel(torch, dev):
    """B6 at 7B width (hidden 4096, 32 heads, d 128, ffn 11008, vocab 32000,
    page 64), R = 4 slots with lens 300/257/311 and one inactive slot, bf16
    and int8 weights: one layer ("layer") and a 2-layer whole step with the
    head ("multi") against the plain version on the same inputs, a
    constructed argmax tie, times beside the engine's op chain."""
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.pallas.decode_megakernel import (
        decode_megakernel, decode_megakernel_reference, megakernel_weight_bytes)
    from paddle_tpu_torch.ops.pallas.rms_norm import rms_rows

    cfg = LlamaConfig(hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=2, num_attention_heads=32)   # 7B width
    model = LlamaForCausalLM(cfg, device=dev, seed=11)
    rows = []
    for wname, quant in (("bf16", None), ("int8", "int8")):
        kw = dict(max_len=512, page_size=64, max_batch=4, quant=quant,
                  weight_dtype="bfloat16", device=dev)
        eng = ContinuousBatchingEngine(model, megakernel="multi", **kw)
        oc = ContinuousBatchingEngine(model, megakernel=False, **kw)
        tok, table, lens, act = megakernel_inputs(torch, dev, eng, seed=12)
        for a, b in zip(oc._k_flat + oc._v_flat, eng._k_flat + eng._v_flat):
            a.copy_(b)
        pack = eng._mk_pack
        h0 = eng.weights["emb"][tok].to(pack.dtype)
        wrows = written_rows(pack, table, lens, act)
        # 1. one layer
        ref = clone_pack(pack)
        h_k = decode_megakernel(h0.clone(), pack, table, lens, act, layer=0)
        h_r = decode_megakernel_reference(h0.clone(), ref, table, lens, act, layer=0)
        torch.cuda.synchronize()
        err_h1 = max_err(h_k, h_r)
        err_kv1, untouched1 = pools_diff(pack, ref, wrows, layers=(0,))
        # 2. the whole step, from the same pools on both sides
        ref = clone_pack(pack)
        hk, tk, mk, lk = decode_megakernel(h0.clone(), pack, table, lens, act, head=True)
        hr, tr, mr, lr = decode_megakernel_reference(h0.clone(), ref, table, lens, act,
                                                     head=True)
        torch.cuda.synchronize()
        err_h2, err_logits = max_err(hk, hr), max_err(lk, lr)
        err_kv2, untouched2 = pools_diff(pack, ref, wrows, layers=(0, 1))
        top2 = torch.topk(lr.float(), 2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 0.1
        tok_ok = bool((tk == tr)[decided].all())
        # bf16 keeps 8 significant bits: the kernel and the op chain round
        # the same values at the same points but sum in other orders, so an
        # emitted value may differ by one rounding (2^-8 of its magnitude),
        # and such differences pass through the following layers; hold each
        # output to 2^-5 of its largest entry (a few roundings)
        tol = {n: 2 ** -5 * float(r.float().abs().max()) for n, r in
               (("h1", h_r), ("h2", hr), ("logits", lr))}
        # 3. the tie: three identical columns, made each row's maximum
        set_tie(torch, pack, rms_rows(hr, pack.norm, pack.eps))
        ref = clone_pack(pack)
        _, t_tie, _, l_tie = decode_megakernel(h0.clone(), pack, table, lens, act, head=True)
        _, t_tie_r, _, _ = decode_megakernel_reference(h0.clone(), ref, table, lens, act,
                                                       head=True)
        torch.cuda.synchronize()
        c0 = MK_TIE[0]
        tie_ok = (all(torch.equal(l_tie[:, c0], l_tie[:, c]) for c in MK_TIE)
                  and bool((l_tie.argmax(-1) == c0).all())
                  and t_tie.tolist() == [c0] * 4 and t_tie_r.tolist() == [c0] * 4)
        grid = decode_megakernel.grid
        row = dict(weights=wname, R=4, lens=MK_LENS, active=MK_ACTIVE, layers=2,
                   grid=grid, max_abs_err=max(err_h2, err_logits),
                   layer_h_err=err_h1, layer_kv_err=err_kv1, step_h_err=err_h2,
                   step_kv_err=err_kv2, logits_err=err_logits, tol=tol,
                   untouched_rows_equal=untouched1 and untouched2,
                   tok_decided=int(decided.sum()), tok_equal_where_decided=tok_ok,
                   tie_cols=list(MK_TIE), tie_tok=t_tie.tolist(), tie_ok=tie_ok)
        row["ok"] = (err_h1 <= tol["h1"] and err_kv1 <= tol["h1"] and err_h2 <= tol["h2"]
                     and err_kv2 <= tol["h2"] and err_logits <= tol["logits"]
                     and row["untouched_rows_equal"] and tok_ok and tie_ok)
        # times: the kernel (h restored before each call), the plain
        # version, one "layer" launch, and the engine's op chain on the
        # same inputs (norms, projections, B3 attention, B4 if int8, head)
        h_t = h0.clone()

        def run(**kw):
            h_t.copy_(h0)
            return decode_megakernel(h_t, pack, table, lens, act, **kw)

        row["ms"] = time_ms(torch, lambda: run(head=True))
        row["layer_ms"] = time_ms(torch, lambda: run(layer=0))
        row["plain_ms"] = time_ms(torch, lambda: decode_megakernel_reference(
            h0.clone(), ref, table, lens, act, head=True), iters=3)
        t64, l64, a_b = table.long(), lens.long(), act.bool()
        row["opchain_ms"] = time_ms(torch, lambda: oc._decode_math(tok, t64, l64, a_b))
        row["library_ms"] = None      # no one PyTorch call computes a decode step
        live = sum(L + 1 for L, a in zip(MK_LENS, MK_ACTIVE) if a)
        kv_bytes = 2 * live * pack.nh_kv * pack.hd * 2 * pack.n_layers
        w_bytes = megakernel_weight_bytes(pack)
        n_bytes = w_bytes + kv_bytes + 2 * 4 * pack.H * 2 + 4 * pack.V * 2
        params = sum(t.numel() for ws in pack.layers for k in
                     ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
                     for t in [ws[k][0] if isinstance(ws[k], tuple) else ws[k]])
        row["weight_gb"] = w_bytes / 1e9
        row["bound_ms"], row["bound_by"] = bound_ms(
            n_bytes, 2 * 4 * (params + pack.H * pack.V))
        rows.append(row)
        del eng, oc, pack, ref
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return rows + megakernel_f32_rows(torch, dev)


# the fold's rows: R = 4 as the greedy row (MK_LENS, one inactive slot) and
# R = 8, the CB engine's full bucket (two inactive slots)
TOPK_LENS = {4: MK_LENS, 8: [300, 257, 311, 290, 120, 64, 500, 33]}
TOPK_ACTIVE = {4: MK_ACTIVE, 8: [1, 1, 1, 0, 1, 1, 0, 1]}
TOPK_KS = (8, 128)


def topk_inputs(torch, dev, eng, R, seed):
    """megakernel_inputs for R rows (TOPK_LENS / TOPK_ACTIVE)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    for f in eng._k_flat + eng._v_flat:
        f.copy_(torch.randn(f.shape, generator=g, device=dev))
    mp = eng.max_pages_per_seq
    table = torch.randperm(eng.n_pages, generator=g, device=dev)[:R * mp]
    table = table.reshape(R, mp).to(torch.int32)
    lens = torch.tensor(TOPK_LENS[R], dtype=torch.int32, device=dev)
    act = torch.tensor(TOPK_ACTIVE[R], dtype=torch.int32, device=dev)
    tok = torch.randint(0, eng.cfg.vocab_size, (R,), generator=g, device=dev)
    return tok, table, lens, act


def check_megakernel_topk(torch, dev, ptxas):
    """The megakernel's top-K fold (head_k > 1) at 7B width, 2 layers and
    the head, bf16 and int8, R = 4 and 8, K = 8 and 128. Gates, each exact:
    (topv, topi) equal a stable top-K of a head_k = 1 launch's logits on
    the same inputs, column 0 that launch's token, h equal; a constructed
    cross-block tie (columns MK_TIE) comes out id-ascending; a fold launch
    allocates no logits buffer. Against the plain version: values within
    2^-5 of the largest logit (bf16 roundings, as the greedy row), ids
    equal where the plain top-(K+1) gaps exceed 0.1. Times: the fold, the
    greedy head, the library arm (the greedy launch plus a stable sort of
    its logits), the plain version; the bound is the greedy head's."""
    from paddle_tpu_torch.inference.sampling import top_k
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.pallas.decode_megakernel import (
        decode_megakernel, decode_megakernel_reference, megakernel_weight_bytes)
    from paddle_tpu_torch.ops.pallas.rms_norm import rms_rows

    cfg = LlamaConfig(hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=2, num_attention_heads=32)   # 7B width
    model = LlamaForCausalLM(cfg, device=dev, seed=11)
    regs = [ln for ln in ptxas if "decode_megakernel" in ln]
    rows = []
    for wname, quant in (("bf16", None), ("int8", "int8")):
        for R in (4, 8):
            eng = ContinuousBatchingEngine(
                model, megakernel="multi", max_len=512, page_size=64, max_batch=R,
                quant=quant, weight_dtype="bfloat16", device=dev)
            tok, table, lens, act = topk_inputs(torch, dev, eng, R, seed=12)
            pack = eng._mk_pack
            h0 = eng.weights["emb"][tok].to(pack.dtype)
            # the greedy launch and the plain version, from the same pools
            p_g = clone_pack(pack)
            h_g, tok_g, _, lg = decode_megakernel(h0.clone(), p_g, table, lens, act,
                                                  head=True)
            p_r = clone_pack(pack)
            h_r, _, _, lr = decode_megakernel_reference(h0.clone(), p_r, table, lens,
                                                        act, head=True)
            torch.cuda.synchronize()
            tol = 2 ** -5 * float(lr.float().abs().max())
            live = sum(L + 1 for L, a in zip(TOPK_LENS[R], TOPK_ACTIVE[R]) if a)
            kv_bytes = 2 * live * pack.nh_kv * pack.hd * 2 * pack.n_layers
            n_bytes = megakernel_weight_bytes(pack) + kv_bytes + 2 * R * pack.H * 2
            params = sum(t.numel() for ws in pack.layers for k in
                         ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
                         for t in [ws[k][0] if isinstance(ws[k], tuple) else ws[k]])
            h_t = h0.clone()

            def run(**kw):
                h_t.copy_(h0)
                return decode_megakernel(h_t, pack, table, lens, act, head=True, **kw)

            greedy_ms = time_ms(torch, lambda: run())
            for K in TOPK_KS:
                p_k = clone_pack(pack)
                h_k, topv, topi = decode_megakernel(h0.clone(), p_k, table, lens, act,
                                                    head=True, head_k=K)
                outputs = decode_megakernel.outputs
                torch.cuda.synchronize()
                sv, si = top_k(lg, K)
                identical = (torch.equal(topv, sv.float()) and torch.equal(topi, si.int())
                             and torch.equal(topi[:, 0], tok_g) and torch.equal(h_k, h_g))
                pv, pi = top_k(lr, K + 1)
                pv = pv.float()
                gaps = pv[:, :-1] - pv[:, 1:]
                # a plain id is held where it is separated from both neighbours
                sep = torch.ones_like(gaps[:, :1], dtype=torch.bool)
                decided = (gaps > 0.1) & torch.cat([sep, gaps[:, :-1] > 0.1], 1)
                ids_ok = bool((topi == pi[:, :K].int())[decided].all())
                err = max_err(topv, pv[:, :K])
                plain_ms = time_ms(torch, lambda: decode_megakernel_reference(
                    h0.clone(), p_r, table, lens, act, head=True, head_k=K), iters=3)

                def library():
                    _, _, _, logits = run()
                    return top_k(logits, K)

                row = dict(weights=wname, R=R, head_k=K, lens=TOPK_LENS[R],
                           active=TOPK_ACTIVE[R], layers=2, grid=decode_megakernel.grid,
                           topk_fold_identical=identical, outputs=list(outputs),
                           no_logits_buffer=tuple(outputs) == ("topi", "topv"),
                           max_abs_err=err, tol=tol, ids_decided=int(decided.sum()),
                           ids_equal_where_decided=ids_ok,
                           ms=time_ms(torch, lambda: run(head_k=K)),
                           greedy_ms=greedy_ms, library_ms=time_ms(torch, library),
                           library="the greedy launch + a stable torch.sort top-K of "
                                   "its [R, V] logits", plain_ms=plain_ms)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    n_bytes, 2 * R * (params + pack.H * pack.V))
                row["ok"] = (identical and row["no_logits_buffer"] and err <= tol
                             and ids_ok)
                rows.append(row)
                del p_k
            # the tie: MK_TIE columns identical and each row's maximum, on
            # slabs of different blocks (slab 0 and slab 968 of 132 blocks)
            set_tie(torch, pack, rms_rows(h_r, pack.norm, pack.eps))
            _, _, _, l_tie = decode_megakernel(h0.clone(), clone_pack(pack), table,
                                               lens, act, head=True)
            _, tv, ti = decode_megakernel(h0.clone(), clone_pack(pack), table, lens,
                                          act, head=True, head_k=8)
            torch.cuda.synchronize()
            n = len(MK_TIE)
            # rows whose maximum is the tie must list its columns first, in
            # id order; every row must equal the stable top-8 of the greedy
            # launch's logits
            at_max = (l_tie.argmax(-1) == MK_TIE[0]).tolist()
            front = [ti[i, :n].tolist() == list(MK_TIE)
                     and bool((tv[i, :n] == tv[i, 0]).all())
                     for i in range(R) if at_max[i]]
            tie_ok = (len(front) > 0 and all(front)
                      and torch.equal(ti, top_k(l_tie, 8)[1].int()))
            rows.append(dict(weights=wname, R=R, head_k=8, case="cross-block tie",
                             tie_cols=list(MK_TIE), rows_at_tie=sum(at_max),
                             tie_ids=ti[:, :n].tolist(), ok=tie_ok))
            del eng, pack, p_g, p_r
            torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    for r in rows:
        r["ptxas"] = regs
    return rows


# ---------------------------------------------------------------- phase 3 (spec)
SPEC_T = 4                        # the verify width of every speculative row
SPEC_LENS = TOPK_LENS[8]          # 8 slots, two inactive (as the #7b row)
SPEC_ACTIVE = TOPK_ACTIVE[8]
SPEC_DLEN = [3, 2, 0, 3, 1, 3, 2, 3]   # real drafts per slot: gated rows
#                                        j <= dlen, the others ungated


def verify_identity(torch, dev):
    """B5's verify entry (tq = 4, ctx = lens + 4, q_starts = lens) against
    4 sequential B3 steps on the same pool, row j against the step at
    lens + j: bf16 and f32, page 64 and 8, MHA and a GQA group of 4,
    ragged lengths (one inactive slot, one of length 0); and the verify
    launch's staged walk against its direct walk (`stages` 0)."""
    from paddle_tpu_torch.ops.pallas import paged_attention as pa
    T, cases = SPEC_T, []
    for dt in (torch.bfloat16, torch.float32):
        for p in (64, 8):
            for h, h_kv in ((32, 32), (32, 8)):
                lens, active = [300, 257, 0, 290, 129], [1, 1, 1, 0, 1]
                b, d, mp = len(lens), 128, -(-(max(lens) + T) // p)
                g = torch.Generator(device=dev).manual_seed(6)
                q = torch.randn((b, T, h, d), generator=g, device=dev).to(dt)
                kp = torch.randn((b * mp, p, h_kv, d), generator=g, device=dev).to(dt)
                vp = torch.randn((b * mp, p, h_kv, d), generator=g, device=dev).to(dt)
                table = torch.randperm(b * mp, generator=g, device=dev)
                table = table.reshape(b, mp).to(torch.int32)
                ln = torch.tensor(lens, dtype=torch.int32, device=dev)
                ac = torch.tensor(active, dtype=torch.int32, device=dev)
                ver = pa.spec_verify_attention(q, kp, vp, table, ln, active=ac)
                seq = torch.stack([pa.paged_attention(q[:, j], kp, vp, table, ln + j + 1,
                                                      active=ac) for j in range(T)], 1)
                direct = pa._ragged_launch(q, kp, vp, table, ln + T, ln, ac,
                                           1.0 / math.sqrt(d), 0)
                torch.cuda.synchronize()
                cases.append(dict(dtype=str(dt), page=p, h=h, h_kv=h_kv,
                                  route=pa.paged_route(dt, d, p),
                                  stages=pa.paged_stage_plan(dt, d, p)[0],
                                  max_abs_diff=max_err(ver, seq),
                                  identical=bool(torch.equal(ver, seq)),
                                  staged_equals_direct=bool(torch.equal(ver, direct))))
    return cases


def check_spec_verify(torch, dev):
    """`spec_verify_attention` (B5 at tq = 4) at the serving path's shape:
    8 slots at the #7b lengths (two inactive), 32 heads of d 128, page 64,
    against its plain version; time, plain, library (SDPA masked, K/V
    gathered first, as #4/#5) and bound. Gate: row j equal to sequential
    B3 steps bit for bit (verify_identity)."""
    from paddle_tpu_torch.ops.pallas.paged_attention import (
        paged_route, paged_stage_plan, ragged_paged_attention_reference,
        spec_verify_attention)
    T, b, h, h_kv, d, p, mp = SPEC_T, 8, 32, 32, 128, 64, 16
    q, kp, vp, table = ragged_inputs(torch, dev, b, T, h, h_kv, d, p, mp, torch.bfloat16,
                                     seed=7)
    ln = torch.tensor(SPEC_LENS, dtype=torch.int32, device=dev)
    act = torch.tensor(SPEC_ACTIVE, dtype=torch.int32, device=dev)
    s0 = spec_verify_attention.staged_launches
    got = spec_verify_attention(q, kp, vp, table, ln, active=act)
    route = paged_route(torch.bfloat16, d, p)
    walk_counted = spec_verify_attention.staged_launches - s0 == (route == "staged")
    ref = ragged_paged_attention_reference(q, kp, vp, table, ln + T, ln, active=act)
    torch.cuda.synchronize()
    err = max_err(got, ref)
    tol = 1e-2      # convex mixes of N(0,1) rows: bf16 rounds at ~4e-3
    ident = verify_identity(torch, dev)
    row = dict(case="main", b=b, tq=T, h=h, h_kv=h_kv, d=d, p=p, lens=SPEC_LENS,
               active=SPEC_ACTIVE, route=route,
               stages=paged_stage_plan(torch.bfloat16, d, p)[0], walk_counted=walk_counted,
               max_abs_err=err, tol=tol, sequential=ident,
               sequential_identical=all(c["identical"] for c in ident),
               sequential_max_abs_diff=max(c["max_abs_diff"] for c in ident),
               staged_equals_direct=all(c["staged_equals_direct"] for c in ident))
    row["ok"] = (err <= tol and row["sequential_identical"] and walk_counted
                 and row["staged_equals_direct"])
    row["ms"] = time_ms(torch, lambda: spec_verify_attention(q, kp, vp, table, ln,
                                                             active=act))
    row["plain_ms"] = time_ms(torch, lambda: ragged_paged_attention_reference(
        q, kp, vp, table, ln + T, ln, active=act), iters=5)
    row["library_ms"] = sdpa_paged_ms(torch, q, kp, vp, table, ln, ln + T, act)
    row["library_call"] = LIBRARY_CALL
    row["device_ms"] = graph_ms(torch, lambda: spec_verify_attention(q, kp, vp, table, ln,
                                                                     active=act))
    row["library_device_ms"] = sdpa_paged_ms(torch, q, kp, vp, table, ln, ln + T, act,
                                             graph_ms)
    live = sum(L + T for L, a in zip(SPEC_LENS, SPEC_ACTIVE) if a)
    pairs = sum(L + j + 1 for L, a in zip(SPEC_LENS, SPEC_ACTIVE) if a for j in range(T))
    n_bytes = 2 * b * T * h * d * 2 + live * h_kv * d * 2 * 2 + table.numel() * 4 + 3 * b * 4
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 4 * d * h * pairs)
    return [row]


def check_megakernel_verify(torch, dev, ptxas):
    """B6 at tq = 4 (the speculative verify pass) at 7B width, 2 layers and
    the head, w = 8 slots (SPEC_LENS, two inactive), a write mask of gated
    and ungated rows (SPEC_DLEN), bf16 and int8: 4 launches of 2 slots.
    Gates: h and the logits against the plain version within 2^-5 of their
    largest entry (the #7 row's tolerance), tokens equal where decided;
    the pools against the op chain's verify pass (`_spec_verify_math`,
    written rows within the same tolerance, every other row bit for bit);
    and row (s, j) of the pass equal bit for bit (h, token, logit row) to
    slot s of the j-th of 4 sequential tq = 1 launches at lens + j with
    the same write mask. Times: the pass, the 4 sequential launches, the
    plain version, the op chain's pass; no library call computes it."""
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.pallas.decode_megakernel import (
        decode_megakernel, decode_megakernel_reference, megakernel_weight_bytes)

    cfg = LlamaConfig(hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=2, num_attention_heads=32)   # 7B width
    model = LlamaForCausalLM(cfg, device=dev, seed=11)
    T, w = SPEC_T, 8
    R = w * T
    rows = []
    for wname, quant in (("bf16", None), ("int8", "int8")):
        kw = dict(max_len=512, page_size=64, max_batch=w, quant=quant,
                  weight_dtype="bfloat16", speculate=T, device=dev)
        eng = ContinuousBatchingEngine(model, megakernel="multi", **kw)
        oc = ContinuousBatchingEngine(model, megakernel=False, **kw)
        _, table, lens, act = topk_inputs(torch, dev, eng, w, seed=12)
        for a, b in zip(oc._k_flat + oc._v_flat, eng._k_flat + eng._v_flat):
            a.copy_(b)
        g = torch.Generator(device=dev).manual_seed(14)
        feed = torch.randint(0, cfg.vocab_size, (w, T), generator=g, device=dev)
        dlen = torch.tensor(SPEC_DLEN, device=dev)
        rem = torch.full((w,), 64, device=dev)
        j = torch.arange(T, device=dev)[None, :]
        gate = (act.bool()[:, None] & (j <= dlen[:, None]))
        wm = gate.reshape(R).to(torch.int32)
        pack = eng._mk_pack
        h0 = eng.weights["emb"][feed.reshape(-1)].to(pack.dtype)
        p0 = clone_pack(pack)           # the pools before the pass
        # 1. the pass against the plain version
        ref = clone_pack(p0)
        before = decode_megakernel.launches
        hk, tk, _, lk = decode_megakernel(h0.clone(), pack, table, lens, act, head=True,
                                          tq=T, wmask=wm)
        launches = decode_megakernel.launches - before
        hr, tr, _, lr = decode_megakernel_reference(h0.clone(), ref, table, lens, act,
                                                    head=True, tq=T, wmask=wm)
        torch.cuda.synchronize()
        top2 = torch.topk(lr.float(), 2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 0.1
        tok_ok = bool((tk == tr)[decided].all())
        tol = {n: 2 ** -5 * float(r.float().abs().max()) for n, r in (("h", hr),
                                                                      ("logits", lr))}
        # 2. the pools against the op chain's verify pass
        with torch.no_grad():
            oc._spec_verify_math(feed, table.long(), lens.long(), act.bool(), rem, dlen)
        torch.cuda.synchronize()
        pos = lens.long()[:, None] + j
        wrows = [int(table[s, int(q) // 64]) * 64 + int(q) % 64
                 for s in range(w) for t, q in enumerate(pos[s].tolist()) if gate[s, t]]
        oc_pack = clone_pack(pack)
        oc_pack.k_flat, oc_pack.v_flat = oc._k_flat, oc._v_flat
        err_kv, untouched = pools_diff(pack, oc_pack, wrows + [pack.oob], layers=(0, 1))
        # 3. row (s, j) against the j-th of T sequential tq = 1 launches
        seq = clone_pack(p0)
        same = True
        for t in range(T):
            hs, ts, _, ls = decode_megakernel(
                eng.weights["emb"][feed[:, t]].to(pack.dtype), seq, table, lens + t, act,
                head=True, wmask=wm.reshape(w, T)[:, t].contiguous())
            rs = torch.arange(w, device=dev) * T + t
            same &= (torch.equal(hs, hk[rs]) and torch.equal(ts, tk[rs])
                     and torch.equal(ls, lk[rs]))
        torch.cuda.synchronize()
        row = dict(weights=wname, w=w, tq=T, R=R, lens=SPEC_LENS, active=SPEC_ACTIVE,
                   dlen=SPEC_DLEN, layers=2, launches_per_pass=launches,
                   grid=decode_megakernel.grid, max_abs_err=max(max_err(hk, hr),
                                                                max_err(lk, lr)),
                   h_err=max_err(hk, hr), logits_err=max_err(lk, lr), tol=tol,
                   tok_decided=int(decided.sum()), tok_equal_where_decided=tok_ok,
                   pool_kv_err_vs_op_chain=err_kv, untouched_rows_equal=untouched,
                   sequential_identical=bool(same))
        row["ok"] = (row["h_err"] <= tol["h"] and row["logits_err"] <= tol["logits"]
                     and tok_ok and err_kv <= tol["h"] and untouched and same
                     and launches == -(-w // (8 // T)))
        h_t = h0.clone()

        def run():
            h_t.copy_(h0)
            return decode_megakernel(h_t, pack, table, lens, act, head=True, tq=T, wmask=wm)

        def sequential():
            for t in range(T):
                decode_megakernel(eng.weights["emb"][feed[:, t]].to(pack.dtype), seq,
                                  table, lens + t, act, head=True)

        row["ms"] = time_ms(torch, run)
        row["sequential_ms"] = time_ms(torch, sequential)
        row["plain_ms"] = time_ms(torch, lambda: decode_megakernel_reference(
            h0.clone(), ref, table, lens, act, head=True, tq=T, wmask=wm), iters=3)
        t64, l64, a_b = table.long(), lens.long(), act.bool()
        with torch.no_grad():
            row["opchain_ms"] = time_ms(torch, lambda: oc._spec_verify_math(
                feed, t64, l64, a_b, rem, dlen))
        row["library_ms"] = None     # no one PyTorch call computes a verify pass
        live = sum(L + T for L, a in zip(SPEC_LENS, SPEC_ACTIVE) if a)
        kv_bytes = 2 * live * pack.nh_kv * pack.hd * 2 * pack.n_layers
        n_bytes = (megakernel_weight_bytes(pack) + kv_bytes + 2 * R * pack.H * 2
                   + R * pack.V * 2)
        params = sum(t.numel() for ws in pack.layers for k in
                     ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
                     for t in [ws[k][0] if isinstance(ws[k], tuple) else ws[k]])
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 2 * R * (params
                                                                    + pack.H * pack.V))
        row["ptxas"] = [ln for ln in ptxas if "decode_megakernel" in ln]
        rows.append(row)
        del eng, oc, pack, ref, seq, p0, oc_pack
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 3 (tp)
TP_DEGREES = (2, 4)


def shard_pools(one, eng):
    """Each shard's pools set to its kv-head slice of the tp = 1 engine's."""
    nkl = eng.nh_kv_l
    for s in range(eng.tp):
        for src, dst in ((one._k_flat, eng._kf[s]), (one._v_flat, eng._vf[s])):
            for a, b in zip(src, dst):
                b.copy_(a[:, s * nkl:(s + 1) * nkl])


def tp_walk(torch, hs, packs, table, lens, act, head_k=0, tq=1, wmask=None,
            check=None):
    """One decode step through the tensor-parallel segments, as the engine's
    `_mk_walk_tp` runs it: per layer every shard's qkv launch, the head
    gather, every shard's tail, the column gather, every shard's down; the
    head (head_k >= 1) rides the last layer's down launches. hs are updated
    in place. With `check` (a dict), each launch is also run through the
    plain version on copies of its inputs, and per segment the worst error
    against it and the largest plain value are kept. Returns the last down
    launches' outputs, one per shard."""
    from paddle_tpu_torch.ops.pallas.decode_megakernel import (
        decode_megakernel, decode_megakernel_reference)

    def launch(s, **kw):
        ref = out_r = None
        if check is not None:
            ref = clone_pack(packs[s])
            out_r = decode_megakernel_reference(hs[s].clone(), ref, **kw)
        out = decode_megakernel(hs[s], packs[s], **kw)
        if check is not None:
            seg = kw["seg"]
            pairs = {"qkv": [(out, out_r)], "tail": list(zip(out, out_r))}.get(seg)
            if pairs is None:               # down: h, and the head's logits
                pairs = ([(out, out_r)] if not kw.get("head") else
                         [(out[0], out_r[0])] + ([(out[3], out_r[3])]
                                                 if kw.get("head_k", 1) == 1 else []))
            if seg == "qkv":       # the pools but their scratch row, which
                li = kw["layer"]   # several masked rows write in a race
                pairs += [(packs[s].k_flat[li][:-1], ref.k_flat[li][:-1]),
                          (packs[s].v_flat[li][:-1], ref.v_flat[li][:-1])]
            e, m = check.get(seg, (0.0, 0.0))
            for a, b in pairs:
                e = max(e, max_err(a, b))
                m = max(m, float(b.float().abs().max()))
            check[seg] = (e, m)
        return out

    L, tp = packs[0].n_layers, len(packs)
    outs = None
    for li in range(L):
        attn = torch.cat([launch(s, tables=table, lens=lens, active=act, layer=li,
                                 seg="qkv", tq=tq, wmask=wmask) for s in range(tp)], -1)
        acts = torch.cat([launch(s, layer=li, seg="tail", attn_in=attn, tq=tq)[1]
                          for s in range(tp)], -1)
        head = li == L - 1 and head_k >= 1
        outs = [launch(s, layer=li, seg="down", act_in=acts, tq=tq, head=head,
                       head_k=head_k if head else 1) for s in range(tp)]
    return outs


def check_megakernel_tp(torch, dev, ptxas):
    """#7's tensor-parallel segments (qkv / tail / down) at 7B width, 2
    layers and the head, tp 2 and 4 shards on one card, R = 8 and 4 slots
    (TOPK_LENS, inactive slots among them), bf16 and int8. Each segment
    launch against its plain version on the same inputs, within 2^-5 of
    the plain output's largest entry (the #7 row's tolerance). Bit gates
    against the tp = 1 seg "full" launch from the same pools: the shards'
    h after the step, every shard's pools against its head slice of the
    full launch's, the combined greedy token and the gathered logits; the
    combined top-8 of the shards' folds against the full fold; at R = 8
    also a tq = 4 verify pass (8 slots x 4 rows, the SPEC_DLEN write
    mask). Times: one layer through the segments of every shard (both
    gathers included) beside the tp = 1 layer launch, each segment's sum
    over the shards, the plain version's layer. The bound is one layer's
    weights read once (the tp = 1 layer's), its live KV rows and its rows
    of h, over the memory rate: the replicated wo / wd each shard reads
    again are the segments' cost, not the work's."""
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.tp import TPContext
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.pallas.decode_megakernel import (
        decode_megakernel, megakernel_weight_bytes)

    cfg = LlamaConfig(hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=2, num_attention_heads=32)   # 7B width
    model = LlamaForCausalLM(cfg, device=dev, seed=11)
    regs = [ln for ln in ptxas if "decode_megakernel" in ln]
    rows = []
    for wname, quant in (("bf16", None), ("int8", "int8")):
        kw = dict(megakernel="multi", max_len=512, page_size=64, max_batch=8,
                  quant=quant, weight_dtype="bfloat16")
        one = ContinuousBatchingEngine(model, device=dev, **kw)
        for tp in TP_DEGREES:
            eng = ContinuousBatchingEngine(model, tp=tp, device=[dev] * tp, **kw)
            tpc = TPContext(tp, devices=[dev] * tp)
            v_l = cfg.vocab_size // tp
            for R in (8, 4):
                tok, table, lens, act = topk_inputs(torch, dev, one, R, seed=12)
                shard_pools(one, eng)
                emb = one.weights["emb"]
                h0 = emb[tok].to(torch.bfloat16)
                # the tp = 1 whole step, and the shards' from the same pools
                p1 = clone_pack(one._mk_pack)
                hf, tokf, _, logf = decode_megakernel(h0.clone(), p1, table, lens, act,
                                                      head=True)
                packs = [clone_pack(pk) for pk in eng._mk_packs]
                hs = [h0.clone() for _ in range(tp)]
                check = {}
                outs = tp_walk(torch, hs, packs, table, lens, act, head_k=1, check=check)
                tok_c = tpc.argmax_of_local_max([o[2] for o in outs],
                                                [o[1] for o in outs], v_l)
                log_c = torch.cat([o[3] for o in outs], -1)
                nkl = eng.nh_kv_l
                # every pool row but the scratch row (masked rows race there)
                pools_same = all(
                    torch.equal(getattr(pk, f)[li][:-1],
                                getattr(p1, f)[li][:-1, s * nkl:(s + 1) * nkl])
                    for s, pk in enumerate(packs) for f in ("k_flat", "v_flat")
                    for li in range(2))
                greedy_same = (all(torch.equal(h, hf) for h in hs) and pools_same
                               and torch.equal(tok_c, tokf.long())
                               and torch.equal(log_c, logf))
                # the top-8 fold, from the same pools again
                _, tvf, tif = decode_megakernel(h0.clone(), clone_pack(one._mk_pack),
                                                table, lens, act, head=True, head_k=8)
                folds = tp_walk(torch, [h0.clone() for _ in range(tp)],
                                [clone_pack(pk) for pk in eng._mk_packs], table, lens,
                                act, head_k=8)
                tv, ti = tpc.topk_of_local_topk([f[1] for f in folds],
                                                [f[2] for f in folds], v_l, 8)
                fold_same = torch.equal(tv, tvf) and torch.equal(ti, tif.long())
                torch.cuda.synchronize()
                tol = {seg: 2 ** -5 * m for seg, (_, m) in check.items()}
                errs = {seg: e for seg, (e, _) in check.items()}
                row = dict(weights=wname, tp=tp, R=R, lens=TOPK_LENS[R],
                           active=TOPK_ACTIVE[R], layers=2, case="greedy + fold",
                           devices=[str(dev)] * tp, launches_per_layer=3 * tp,
                           grid=decode_megakernel.grid, max_abs_err=max(errs.values()),
                           seg_errs=errs, tol=tol, full_identical=greedy_same,
                           pools_identical=pools_same, fold_identical=fold_same)
                row["ok"] = (all(errs[k] <= tol[k] for k in errs) and greedy_same
                             and fold_same)
                if R == 8:
                    row.update(verify_tp(torch, dev, one, eng, tpc, v_l))
                    row["ok"] = (row["ok"] and row["verify_identical"]
                                 and row["verify_launches_ok"])
                # times: one layer (every shard's three segments and both
                # gathers; h restored before each) beside the tp = 1 layer
                hs_t = [h0.clone() for _ in range(tp)]
                pk_t = eng._mk_packs

                def layer_tp(seg_only=None, plain=False):
                    from paddle_tpu_torch.ops.pallas.decode_megakernel import \
                        decode_megakernel_reference as ref_fn
                    fn = ref_fn if plain else decode_megakernel
                    for h in hs_t:
                        h.copy_(h0)
                    at = torch.cat([fn(hs_t[s], pk_t[s], table, lens, act, layer=0,
                                       seg="qkv") for s in range(tp)], -1) \
                        if seg_only in (None, "qkv") else at_in
                    ac = torch.cat([fn(hs_t[s], pk_t[s], layer=0, seg="tail",
                                       attn_in=at)[1] for s in range(tp)], -1) \
                        if seg_only in (None, "tail") else ac_in
                    if seg_only in (None, "down"):
                        for s in range(tp):
                            fn(hs_t[s], pk_t[s], layer=0, seg="down", act_in=ac)

                at_in = torch.zeros((R, cfg.hidden_size), dtype=torch.bfloat16,
                                    device=dev)
                ac_in = torch.zeros((R, cfg.intermediate_size), dtype=torch.bfloat16,
                                    device=dev)
                h_1 = h0.clone()

                def layer_one():
                    h_1.copy_(h0)
                    decode_megakernel(h_1, one._mk_pack, table, lens, act, layer=0)

                row["ms"] = time_ms(torch, layer_tp)
                row["seg_ms"] = {seg: time_ms(torch, lambda: layer_tp(seg))
                                 for seg in ("qkv", "tail", "down")}
                row["tp1_layer_ms"] = time_ms(torch, layer_one)
                row["plain_ms"] = time_ms(torch, lambda: layer_tp(plain=True), iters=3)
                row["library_ms"] = None   # none; the tp = 1 launch stands in
                pack = one._mk_pack
                one_layer = [dict(ws) for ws in pack.layers[:1]]
                w_bytes = sum(t.numel() * t.element_size() for ws in one_layer
                              for k in ("ln1", "ln2", "wq", "wk", "wv", "wo", "wg",
                                        "wu", "wd")
                              for t in (ws[k] if isinstance(ws[k], tuple) else (ws[k],)))
                live = sum(L + 1 for L, a in zip(TOPK_LENS[R], TOPK_ACTIVE[R]) if a)
                kv_bytes = 2 * live * pack.nh_kv * pack.hd * 2
                params = sum((ws[k][0] if isinstance(ws[k], tuple) else ws[k]).numel()
                             for ws in one_layer
                             for k in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"))
                row["bound_ms"], row["bound_by"] = bound_ms(
                    w_bytes + kv_bytes + 2 * R * pack.H * 2, 2 * R * params)
                row["ptxas"] = regs
                rows.append(row)
                del packs, hs, p1
            del eng
            torch.cuda.empty_cache()
        del one
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return rows


def verify_tp(torch, dev, one, eng, tpc, v_l):
    """The tq = 4 verify pass through the segments (8 slots x 4 rows, the
    SPEC_DLEN write mask, 4 launches of 2 slots per segment and shard)
    against the tp = 1 seg "full" pass from the same pools: h, the pools,
    the combined tokens and the gathered logits bit for bit."""
    from paddle_tpu_torch.ops.pallas.decode_megakernel import decode_megakernel
    T, w = SPEC_T, 8
    _, table, lens, act = topk_inputs(torch, dev, one, w, seed=13)
    shard_pools(one, eng)
    g = torch.Generator(device=dev).manual_seed(14)
    feed = torch.randint(0, one.cfg.vocab_size, (w, T), generator=g, device=dev)
    j = torch.arange(T, device=dev)[None, :]
    dlen = torch.tensor(SPEC_DLEN, device=dev)
    wm = (act.bool()[:, None] & (j <= dlen[:, None])).reshape(w * T).to(torch.int32)
    h0 = one.weights["emb"][feed.reshape(-1)].to(torch.bfloat16)
    p1 = clone_pack(one._mk_pack)
    hf, tokf, _, logf = decode_megakernel(h0.clone(), p1, table, lens, act, head=True,
                                          tq=T, wmask=wm)
    packs = [clone_pack(pk) for pk in eng._mk_packs]
    hs = [h0.clone() for _ in packs]
    before = decode_megakernel.seg_launches
    outs = tp_walk(torch, hs, packs, table, lens, act, head_k=1, tq=T, wmask=wm)
    n_launch = decode_megakernel.seg_launches - before
    tok = tpc.argmax_of_local_max([o[2] for o in outs], [o[1] for o in outs], v_l)
    nkl = eng.nh_kv_l
    same = (all(torch.equal(h, hf) for h in hs)
            and torch.equal(tok, tokf.long())
            and torch.equal(torch.cat([o[3] for o in outs], -1), logf)
            and all(torch.equal(getattr(pk, f)[li][:-1],
                                getattr(p1, f)[li][:-1, s * nkl:(s + 1) * nkl])
                    for s, pk in enumerate(packs) for f in ("k_flat", "v_flat")
                    for li in range(2)))
    torch.cuda.synchronize()
    return dict(verify_tq=T, verify_rows=w * T, verify_seg_launches=n_launch,
                verify_identical=bool(same),
                verify_launches_ok=n_launch == 3 * 2 * len(packs) * (w // (8 // T)))


# ---------------------------------------------------------------- phase 4
def weight_bytes_per_step(torch, eng):
    """Bytes of every weight a decode step reads (the embedding excluded:
    a step reads b rows of it)."""
    total = 0
    for key, w in eng.weights.items():
        if key in ("emb", "cos", "sin", "eps"):
            continue
        items = [w] if key != "layers" else [x for layer in w for x in layer.values()]
        for it in items:
            for t in (it if isinstance(it, tuple) else (it,)):
                total += t.numel() * t.element_size()
    return total


def serve_7b(torch, dev):
    from paddle_tpu_torch.inference.serving import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    import numpy as np

    cfg = LlamaConfig.llama_7b()
    L = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    engines = {
        "bf16": LLMEngine(model, max_len=512, page_size=64, max_batch=4,
                          weight_dtype="bfloat16", device=dev),
        "int8": LLMEngine(model, max_len=512, page_size=64, max_batch=4,
                          weight_dtype="bfloat16", quant="int8", device=dev),
    }
    del model   # the f32 master: the snapshots are all the engines read
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    prompts = {"short": rng.randint(0, cfg.vocab_size, (4, 12)).astype(np.int64),
               "long": rng.randint(0, cfg.vocab_size, (4, 300)).astype(np.int64)}
    n_new = 16
    H, hd = cfg.hidden_size, cfg.hidden_size // cfg.num_attention_heads
    n_layer_params = L * (2 * H * H + 2 * H * hd * cfg.num_key_value_heads
                          + 3 * H * cfg.intermediate_size)
    n_head_params = H * cfg.vocab_size
    results, launches = [], {}
    for wname, eng in engines.items():
        w_bytes = weight_bytes_per_step(torch, eng)
        step_bound = 1e3 * w_bytes / HBM_BYTES_PER_S
        for pname, ids in prompts.items():
            t0_len = ids.shape[1]
            t_pad = -(-t0_len // eng.page_size) * eng.page_size
            n_loop = min(-(-(n_new - 1) // 32) * 32, eng.max_len - t0_len - 1)
            # warm-up call (cuBLAS handles, allocator), then the counted ones
            eng.generate(ids, max_new_tokens=n_new, device_loop=True)
            torch.cuda.synchronize()
            reset_kernel_launches()
            t = time.perf_counter()
            out1 = eng.generate(ids, max_new_tokens=n_new, device_loop=True)
            total_s = time.perf_counter() - t
            counts = kernel_launches()
            out2 = eng.generate(ids, max_new_tokens=n_new, device_loop=True)
            t = time.perf_counter()
            eng.generate(ids, max_new_tokens=1, device_loop=True)   # prefill only
            prefill_s = time.perf_counter() - t
            expect = dict.fromkeys(counts, 0)
            expect.update({
                "paged_attention": L * n_loop,
                "paged_attention_staged": L * n_loop,
                "quantized_matmul": (7 * L + 1) * (1 + n_loop) if wname == "int8" else 0,
                "flash_attention_fwd": L if t_pad >= eng.flash_prefill_min else 0,
                "flash_attention_fwd_tc": L if t_pad >= eng.flash_prefill_min else 0,
            })
            decode_ms = 1e3 * (total_s - prefill_s) / n_loop
            # prefill reads every weight once; each layer weight meets every
            # padded token, the lm_head only the last one (2 flops per MAC)
            flops = 2 * (n_layer_params * 4 * t_pad + n_head_params * 4)
            prefill_bound = max(w_bytes / HBM_BYTES_PER_S,
                                flops / BF16_FLOPS_PER_S) * 1e3
            ok = (out1.shape == (4, t0_len + n_new)
                  and bool((out1[:, t0_len:] >= 0).all())
                  and bool((out1[:, t0_len:] < cfg.vocab_size).all())
                  and bool((out1 == out2).all()) and counts == expect)
            results.append(dict(
                weights=wname, prompt=pname, prompt_len=t0_len, t_pad=t_pad,
                batch=4, max_new_tokens=n_new, decode_steps=n_loop,
                out_shape=list(out1.shape), repeat_identical=bool((out1 == out2).all()),
                launches=counts, expected_launches=expect,
                prefill_ms=1e3 * prefill_s, prefill_bound_ms=prefill_bound,
                decode_ms_per_step=decode_ms,
                # every slot of every loop step; the loop runs n_loop steps
                # but each row returns only n_new - 1 decode tokens
                decode_step_tokens_per_s=4 * 1e3 / decode_ms,
                served_tokens_per_s=4 * (n_new - 1) / (total_s - prefill_s),
                weight_gb_per_step=w_bytes / 1e9, decode_bound_ms=step_bound,
                tail=out1[0, -4:].tolist(), ok=ok))
            for kname, c in counts.items():
                launches[kname] = launches.get(kname, 0) + c
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del engines
    torch.cuda.empty_cache()
    return dict(setup_s=setup_s, peak_gb=peak_gb, runs=results), launches


# ---------------------------------------------------------------- phase 5
def parity_2layer(torch, dev):
    from paddle_tpu_torch.inference.serving import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    import numpy as np

    cfg = LlamaConfig(hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=2, num_attention_heads=32)   # 7B width
    model = LlamaForCausalLM(cfg, device="cpu", seed=7)
    rng = np.random.RandomState(1)
    prompts = {"short": rng.randint(0, cfg.vocab_size, (2, 12)).astype(np.int64),
               "long": rng.randint(0, cfg.vocab_size, (2, 300)).astype(np.int64)}
    n_new = 8
    # bf16 activations on the card against f32 on the CPU: logits of ~0.5
    # spread carry bf16 rounding of ~1e-2 after two layers; 0.1 leaves room
    tol = 0.1
    rows = []
    for quant in (None, "int8"):
        kw = dict(max_len=512, page_size=64, max_batch=2, quant=quant)
        cpu = LLMEngine(model, device="cpu", **kw)
        gpu = LLMEngine(model, device=dev, weight_dtype="bfloat16", **kw)
        for pname, ids in prompts.items():
            t0 = ids.shape[1]
            err = max_err(gpu.prefill_logits(ids).cpu(), cpu.prefill_logits(ids))
            ids_cpu = cpu.generate(ids, max_new_tokens=n_new)
            ids_gpu = gpu.generate(ids, max_new_tokens=n_new, device_loop=True)
            # a step counts where the CPU run's top-2 margin exceeds the
            # tolerance; a row is followed until the two runs part ways
            compared = equal = 0
            for i in range(ids.shape[0]):
                for t in range(n_new):
                    lg = cpu.prefill_logits(ids_cpu[i:i + 1, :t0 + t])[0]
                    top2 = torch.topk(lg, 2).values
                    same = ids_cpu[i, t0 + t] == ids_gpu[i, t0 + t]
                    if float(top2[0] - top2[1]) > tol:
                        compared += 1
                        equal += int(same)
                    if not same:
                        break
            rows.append(dict(quant=quant or "none", prompt=pname, logits_max_abs_err=err,
                             tol=tol, greedy_compared=compared, greedy_equal=equal,
                             ok=err <= tol and equal == compared))
        del cpu, gpu
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 6
def cb_stream(cfg):
    """12 requests submitted at once (deeper than the 8 slots): prompt
    lengths uniform in 16-700 and budgets uniform in 16-64 from
    RandomState(0); requests 0, 8 and 9 extend one 256-token prefix and
    request 10 is that prefix alone (prefix hits; request 10's last shared
    page is copied on its first write)."""
    import numpy as np
    rng = np.random.RandomState(0)
    lens = rng.randint(16, 701, 12)
    budgets = [int(x) for x in rng.randint(16, 65, 12)]
    prefix = rng.randint(0, cfg.vocab_size, 256).astype(np.int64)
    prompts = [rng.randint(0, cfg.vocab_size, int(t)).astype(np.int64) for t in lens]
    for i in (0, 8, 9):
        tail = rng.randint(0, cfg.vocab_size, max(int(lens[i]) - 256, 1))
        prompts[i] = np.concatenate([prefix, tail.astype(np.int64)])
    prompts[10] = prefix.copy()
    return prompts, budgets


def drive_cb(torch, eng, prompts, budgets, specs=None):
    """Submit the stream (specs: one SamplingParams kwargs dict or None per
    request), step to idle; returns (outputs, wall seconds, ms per decode
    micro-step over the steps that ran decode only)."""
    from paddle_tpu_torch.inference.sampling import SamplingParams
    specs = specs or [None] * len(prompts)
    uids = [eng.add_request(p, n, sampling=None if sp is None else SamplingParams(**sp))
            for p, n, sp in zip(prompts, budgets, specs)]
    torch.cuda.synchronize()
    dec_s, dec_n = 0.0, 0
    t_all = time.perf_counter()
    while True:
        pf0, d0 = eng.prefill_steps, eng.decode_steps
        t = time.perf_counter()
        if not eng.step():
            break
        torch.cuda.synchronize()
        if eng.prefill_steps == pf0 and eng.decode_steps > d0:
            dec_s += time.perf_counter() - t
            dec_n += eng.decode_steps - d0
    wall = time.perf_counter() - t_all
    outs = [eng.result(u) for u in uids]
    return outs, wall, (1e3 * dec_s / dec_n if dec_n else None)


# the stream's runs: name, decode_block, quant, megakernel. The first three
# are pinned to the op chain so that their rows stay comparable with the
# runs before the megakernel existed (auto turns it on on CUDA); the other
# three take the megakernel and are compared with the op-chain run of the
# same K and weights.
CB_RUNS = (("K=8 bf16", 8, None, False), ("K=8 int8", 8, "int8", False),
           ("K=1 bf16", 1, None, False), ("multi K=8 bf16", 8, None, "multi"),
           ("multi K=8 int8", 8, "int8", "multi"), ("layer K=8 bf16", 8, None, "layer"))


def profile_blocks(torch, eng, vocab, n_steps=3):
    """Device busy share of a steady decode stretch: 8 requests (64-token
    prompts, budget 48) are admitted and prefilled, one decode block runs,
    then `n_steps` engine steps (fused blocks) are timed. The stretch runs
    twice, the second time under torch.profiler: the share is the device
    time of every CUDA event in the profiled window over the unprofiled
    window's wall time (the profiler slows the host, not the device)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def stretch(prof=None):
        rng = np.random.RandomState(5)
        for _ in range(8):
            eng.add_request(rng.randint(0, vocab, 64).astype(np.int64), 48)
        while any(r is None or r.state != "decode" for r in eng._slots):
            eng.step()
        eng.step()                  # the first decode block (chains the next)
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
        if prof is not None:
            prof.stop()
        eng.drain()
        return wall_ms

    wall_ms = stretch()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof_wall_ms = stretch(prof)
    busy_ms = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    return dict(steps=n_steps, microsteps=n_steps * eng.decode_block, wall_ms=wall_ms,
                profiled_wall_ms=prof_wall_ms, busy_ms=busy_ms or None,
                busy_share=busy_ms / wall_ms if busy_ms else None)


def tc_prefill(counts):
    """Every chunked-prefill launch of a CB stream (bf16, 128-token chunks,
    d 128, page 64) went through the ragged kernel's tensor-core build."""
    return counts["ragged_paged_attention_tc"] == counts["ragged_paged_attention"]


def serve_cb_7b(torch, dev):
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    import numpy as np

    cfg = LlamaConfig.llama_7b()
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    geom = dict(page_size=64, max_len=1024, max_batch=8, prefill_chunk=128,
                prefix_cache=True, weight_dtype="bfloat16", device=dev)
    prompts, budgets = cb_stream(cfg)
    prompt_tokens = int(sum(p.size for p in prompts))
    results, launches, base, busy, streams = [], {}, {}, {}, {}
    for name, K, quant, mk in CB_RUNS:
        eng = ContinuousBatchingEngine(model, decode_block=K, quant=quant,
                                       megakernel=mk, **geom)
        torch.cuda.synchronize()
        reset_kernel_launches()
        outs, wall, dec_ms = drive_cb(torch, eng, prompts, budgets)
        counts = kernel_launches()
        h1 = eng.health()
        outs2, wall2, _ = drive_cb(torch, eng, prompts, budgets)   # warm cache
        h2 = eng.health()
        gen = int(sum(o.size - p.size for o, p in zip(outs, prompts)))
        dec = h1["decode_steps"]
        n_blk_pf = counts["ragged_paged_attention"] // L
        pf_calls = n_blk_pf if K > 1 else h1["prefill_steps"]
        # int8: 7L+1 matmul launches per prefill block (or chunk); per decode
        # step 7L+1 on the op chain, 1 (the head) in "layer" mode, 0 in "multi"
        per_dec = {False: 7 * L + 1, "layer": 1, "multi": 0}[mk]
        expect_qmm = (7 * L + 1) * pf_calls + per_dec * dec if quant else 0
        expect_mk = {False: 0, "layer": L * dec, "multi": dec}[mk]
        launch_ok = (counts["flash_attention_fwd"] == 0
                     and counts["paged_attention"] == (0 if mk else L * dec)
                     and counts["paged_attention_staged"] == counts["paged_attention"]
                     and counts["decode_megakernel"] == expect_mk
                     and dec > 0
                     and counts["quantized_matmul"] == expect_qmm
                     and (counts["quantized_matmul"] > 0) == bool(quant)
                     and counts["ragged_paged_attention"] % L == 0
                     and ((counts["ragged_paged_attention"] > 0) if K > 1
                          else counts["ragged_paged_attention"] == 0)
                     and tc_prefill(counts))
        row = dict(run=name, decode_block=K, weights=quant or "bf16",
                   megakernel=h1["megakernel"], requests=len(prompts),
                   prompt_tokens=prompt_tokens, generated_tokens=gen)
        if mk:
            # the op-chain run of the same K and weights: the same schedule
            # (no EOS, so blocks do not depend on the tokens), so the same
            # decode steps and prefill launches; the token share is
            # position-wise over the generated tokens
            ref = base[(K, quant)]
            launch_ok = (launch_ok and dec == ref["decode_steps"]
                         and counts["ragged_paged_attention"] == ref["ragged"]
                         and h1["megakernel"] == mk
                         and h1["megakernel_whole_step"] == (mk == "multi"))
            same = sum(int((o[p.size:] == r[p.size:]).sum())
                       for o, r, p in zip(outs, ref["outs"], prompts))
            row["tokens_equal_to_op_chain"] = same / gen
        else:
            base[(K, quant)] = dict(decode_steps=dec, outs=outs,
                                    ragged=counts["ragged_paged_attention"])
        streams[name] = outs
        repeat = all(np.array_equal(a, b) for a, b in zip(outs, outs2))
        in_vocab = all(bool(((o >= 0) & (o < V)).all()) for o in outs)
        budget_ok = all(o.size == p.size + n for o, p, n in zip(outs, prompts, budgets))
        no_leak = all(h["pages_free"] + h["prefix_pages"] == h["pages_total"]
                      for h in (h1, h2))
        ok = (launch_ok and repeat and in_vocab and budget_ok and no_leak
              and h1["done"] == len(prompts) and h2["done"] == 2 * len(prompts)
              and (h1["fused_blocks"] > 0) == (K > 1)
              and h2["prefix_hits"] > 0 and h2["cow_copies"] > 0)
        row.update(
            wall_s=wall, generated_tokens_per_s=gen / wall, wall_s_warm_cache=wall2,
            ms_per_decode_microstep=dec_ms,
            fused_blocks=h1["fused_blocks"], chained_blocks=h1["chained_blocks"],
            prefill_steps=h1["prefill_steps"], decode_steps=dec,
            prefill_blocks=n_blk_pf if K > 1 else None,
            prefix_hits=[h1["prefix_hits"], h2["prefix_hits"] - h1["prefix_hits"]],
            cow_copies=[h1["cow_copies"], h2["cow_copies"] - h1["cow_copies"]],
            launches=counts, expected_qmm=expect_qmm, expected_megakernel=expect_mk,
            launches_ok=launch_ok, repeat_identical=repeat, ids_in_vocab=in_vocab,
            budgets_met=budget_ok, no_leak=no_leak, tail=outs[0][-4:].tolist(), ok=ok)
        if name in ("K=8 bf16", "multi K=8 bf16"):
            busy[name] = row["profile"] = profile_blocks(torch, eng, V)
        results.append(row)
        for kname, c in counts.items():
            launches[kname] = launches.get(kname, 0) + c
        del eng
        torch.cuda.empty_cache()
    sampled = sampled_cb_runs(torch, model, geom, prompts, budgets, results, launches,
                              streams)
    proc = proc_run(torch, model, geom, launches)
    spec = spec_cb_runs(torch, model, geom, prompts, budgets, streams, launches)
    # one request on a fresh op-chain engine: three prefill-only blocks (300
    # tokens in chunks of 128), then two decode blocks of 8, the second chained
    eng = ContinuousBatchingEngine(model, decode_block=8, megakernel=False, **geom)
    ids = np.random.RandomState(1).randint(0, V, 300).astype(np.int64)
    reset_kernel_launches()
    out = eng.generate_many([ids], max_new_tokens=17)[0]
    counts = kernel_launches()
    h = eng.health()
    expect = dict.fromkeys(counts, 0)
    expect.update({"paged_attention": 2 * 8 * L, "paged_attention_staged": 2 * 8 * L,
                   "ragged_paged_attention": 3 * L, "ragged_paged_attention_tc": 3 * L})
    single = dict(run="single t0=300 budget=17 K=8", launches=counts,
                  expected_launches=expect, fused_blocks=h["fused_blocks"],
                  chained_blocks=h["chained_blocks"], out_len=int(out.size),
                  ok=counts == expect and out.size == 317 and h["chained_blocks"] == 1
                  and h["pages_free"] + h["prefix_pages"] == h["pages_total"])
    for kname, c in counts.items():
        launches[kname] = launches.get(kname, 0) + c
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del eng
    torch.cuda.empty_cache()
    width = width_runs(torch, model, geom)
    tp = tp_cb_runs(torch, model, geom, prompts, budgets, streams, launches)
    del model
    torch.cuda.empty_cache()
    return dict(runs=results, single=single, sampled=sampled, proc=proc, spec=spec,
                width=width, tp=tp, peak_gb=peak_gb, busy=busy), launches


# The block-width gate: 5 requests submitted one engine step apart, so that
# their prefills run at slot widths 1, 2, 4 and 8; prompts of 200-520 tokens
# (several 128-token chunks), four of them extending one WIDTH_PREFIX-token
# prefix (prefix hits: the warm run skips those pages and prefills at other
# offsets, widths and company)
WIDTH_PREFIX = 192
WIDTH_LENS, WIDTH_BUDGETS = (300, 450, 200, 520, 380), (24, 16, 20, 16, 24)


def width_stream(cfg):
    import numpy as np
    rng = np.random.RandomState(7)
    prefix = rng.randint(0, cfg.vocab_size, WIDTH_PREFIX).astype(np.int64)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int64) for n in WIDTH_LENS]
    for i in (0, 1, 3, 4):
        prompts[i][:WIDTH_PREFIX] = prefix
    return prompts, list(WIDTH_BUDGETS)


def drive_staggered(torch, eng, prompts, budgets):
    """Submit one request per engine step, then step to idle; returns the
    outputs and the slot widths the prefill phase was called at (before
    its padding to max_batch)."""
    widths, phase = [], eng._prefill_phase

    def spy(ids, *a, **k):
        widths.append(int(ids.shape[0]))
        return phase(ids, *a, **k)

    eng._prefill_phase = spy
    uids = []
    for p, n in zip(prompts, budgets):
        uids.append(eng.add_request(p, n))
        eng.step()
    while eng.step():
        pass
    torch.cuda.synchronize()
    del eng._prefill_phase
    return [eng.result(u) for u in uids], widths


def width_runs(torch, model, geom):
    """The staggered stream on the op chain (bf16) at decode_block 8 and 4,
    each cold and then warm (prefix hits), unspeculated and at speculate=4
    (n-gram drafts): within each, the four id streams equal bit for bit,
    and the cold runs prefilled at several widths below max_batch (the op
    chain runs a fused block's prefill, its decode steps and its verify
    passes at max_batch slots, so a row's bits do not depend on the
    schedule)."""
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    import numpy as np
    prompts, budgets = width_stream(model.config)
    runs, refs = [], {}
    for spec in (None, 4):
        for K in (8, 4):
            eng = ContinuousBatchingEngine(model, decode_block=K, megakernel=False,
                                           speculate=spec, **geom)
            for cache in ("cold", "warm"):
                hits0 = eng.health()["prefix_hits"]
                outs, widths = drive_staggered(torch, eng, prompts, budgets)
                ref = refs.setdefault(spec, outs)
                narrow = sorted({w for w in widths if w < eng.max_batch})
                runs.append(dict(
                    speculate=spec, decode_block=K, cache=cache, prefill_widths=narrow,
                    prefix_hits=eng.health()["prefix_hits"] - hits0,
                    ids_equal=all(np.array_equal(a, b) for a, b in zip(outs, ref)),
                    budgets_met=all(o.size == p.size + n
                                    for o, p, n in zip(outs, prompts, budgets))))
            del eng
            torch.cuda.empty_cache()
    ok = (all(r["ids_equal"] and r["budgets_met"] for r in runs)
          and all(len(r["prefill_widths"]) >= 2 for r in runs if r["cache"] == "cold")
          and all(r["prefix_hits"] > 0 for r in runs if r["cache"] == "warm"))
    return dict(run="staggered stream, op chain bf16, K 8 and 4, cold and warm, speculate "
                "off and 4", requests=len(prompts), prompt_lens=list(WIDTH_LENS),
                prefix=WIDTH_PREFIX, runs=runs,
                spec_equals_unspeculated=all(np.array_equal(a, b) for a, b
                                             in zip(refs[None], refs[4])),
                ok=ok)


# the sampled stream: the cb_stream prompts and budgets; every third request
# (1, 4, 7, 10) greedy, the others sampled at temperature 0.8, top_p 0.9,
# min_p 0.05, top_k 8 or 4 (sample_k = 8), seed 1000 + i
def sampled_specs(n):
    return [None if i % 3 == 1 else
            dict(do_sample=True, temperature=0.8, top_p=0.9, min_p=0.05,
                 top_k=8 if i % 3 == 0 else 4, seed=1000 + i) for i in range(n)]


# name, quant, megakernel, the greedy run of cb_path it is compared with
SAMPLED_RUNS = (("sampled multi K=8 bf16", None, "multi", "multi K=8 bf16"),
                ("sampled multi K=8 int8", "int8", "multi", "multi K=8 int8"),
                ("sampled K=8 bf16", None, False, "K=8 bf16"))


def count_sampled_steps(eng):
    """Wrap the engine's fused scan to count the micro-steps it runs in
    "sampled" mode (each one launch of the fold in "multi" mode). The
    wrapper refers to the engine: `del eng._decode_scan` before dropping
    the engine, or its memory waits for the cycle collector."""
    counter = {"sampled": 0}
    scan = eng._decode_scan

    def counted(tables, tok, lens, act, rem, eos, mode="greedy", ex=None):
        if mode == "sampled":
            counter["sampled"] += eng.decode_block
        return scan(tables, tok, lens, act, rem, eos, mode, ex)

    eng._decode_scan = counted
    return counter


def sampled_cb_runs(torch, model, geom, prompts, budgets, greedy_rows, launches,
                    streams):
    """The CB stream with a mix of greedy and sampled requests at full 7B
    width, K=8: "multi" bf16 and int8 (the top-K fold) and the op chain,
    each twice. Gates: every request finishes its budget, the second run
    (the same seeds) gives the same ids, the fold launches once per
    sampled micro-step and the megakernel once per micro-step. Reports ms
    per decode micro-step and generated tok/s beside the greedy run's."""
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    import numpy as np

    L, V = model.config.num_hidden_layers, model.config.vocab_size
    specs = sampled_specs(len(prompts))
    greedy = {r["run"]: r for r in greedy_rows}
    rows, outs_by = [], {}
    for name, quant, mk, gname in SAMPLED_RUNS:
        eng = ContinuousBatchingEngine(model, decode_block=8, quant=quant, megakernel=mk,
                                       sample_k=8, **geom)
        steps = count_sampled_steps(eng)
        torch.cuda.synchronize()
        reset_kernel_launches()
        outs, wall, dec_ms = drive_cb(torch, eng, prompts, budgets, specs)
        counts = kernel_launches()
        h1 = eng.health()
        n_sampled = steps["sampled"]
        outs2, _, _ = drive_cb(torch, eng, prompts, budgets, specs)
        h2 = eng.health()
        dec = h1["decode_steps"]
        gen = int(sum(o.size - p.size for o, p in zip(outs, prompts)))
        if mk == "multi":
            launch_ok = (counts["decode_megakernel"] == dec
                         and counts["decode_megakernel_topk"] == n_sampled > 0
                         and counts["paged_attention"] == 0)
        else:
            launch_ok = (counts["decode_megakernel"] == 0
                         and counts["decode_megakernel_topk"] == 0
                         and counts["paged_attention"] == L * dec)
        launch_ok = (launch_ok and tc_prefill(counts)
                     and counts["paged_attention_staged"] == counts["paged_attention"])
        outs_by[name] = streams[name] = outs
        g = greedy[gname]
        row = dict(run=name, decode_block=8, weights=quant or "bf16",
                   megakernel=h1["megakernel"], requests=len(prompts),
                   sampled_requests=h1["sampled_requests"], generated_tokens=gen,
                   wall_s=wall, generated_tokens_per_s=gen / wall,
                   ms_per_decode_microstep=dec_ms, decode_steps=dec,
                   sampled_microsteps=n_sampled, launches=counts,
                   greedy_run=gname, greedy_ms_per_decode_microstep=g["ms_per_decode_microstep"],
                   greedy_generated_tokens_per_s=g["generated_tokens_per_s"],
                   ms_ratio_sampled_over_greedy=(dec_ms / g["ms_per_decode_microstep"]
                                                 if dec_ms and g["ms_per_decode_microstep"]
                                                 else None),
                   launches_ok=launch_ok,
                   all_finished=h1["done"] == len(prompts) and h2["done"] == 2 * len(prompts),
                   budgets_met=all(o.size == p.size + n
                                   for o, p, n in zip(outs, prompts, budgets)),
                   repeat_identical=all(np.array_equal(a, b) for a, b in zip(outs, outs2)),
                   ids_in_vocab=all(bool(((o >= 0) & (o < V)).all()) for o in outs),
                   no_leak=all(h["pages_free"] + h["prefix_pages"] == h["pages_total"]
                               for h in (h1, h2)),
                   tail=outs[0][-4:].tolist())
        row["ok"] = (launch_ok and row["all_finished"] and row["budgets_met"]
                     and row["repeat_identical"] and row["ids_in_vocab"] and row["no_leak"])
        rows.append(row)
        for kname, c in counts.items():
            launches[kname] = launches.get(kname, 0) + c
        del eng._decode_scan, eng
        torch.cuda.empty_cache()
    ref = outs_by["sampled K=8 bf16"]
    for row in rows:
        outs = outs_by[row["run"]]
        same = sum(int((o[p.size:] == r[p.size:]).sum())
                   for o, r, p in zip(outs, ref, prompts))
        row["tokens_equal_to_op_chain"] = same / row["generated_tokens"]
    return rows


# cb_spec: the cb_stream requests at speculate=4, K=8 (name, megakernel,
# drafter, sampled, the unspeculated stream of cb_path / cb_sampled it is
# held against)
SPEC_RUNS = (("spec multi K=8 bf16 ngram", "multi", "ngram", False, "multi K=8 bf16"),
             ("spec multi K=8 bf16 oracle", "multi", "oracle", False, "multi K=8 bf16"),
             ("spec K=8 bf16 ngram", False, "ngram", False, "K=8 bf16"),
             ("spec sampled multi K=8 bf16 ngram", "multi", "ngram", True,
              "sampled multi K=8 bf16"))


def oracle_drafter(rows):
    """A drafter that proposes the continuation of the row (an unspeculated
    run's output) the context is a prefix of: every draft is the target's
    own token, so every verify row must score like a sequential step for
    the drafts to be accepted."""
    import numpy as np
    from paddle_tpu_torch.inference.speculative import Drafter

    class Oracle(Drafter):
        name = "oracle"

        def propose(self, ctx, k):
            ctx = np.asarray(ctx)
            for row in rows:
                if row.size > ctx.size and (row[:ctx.size] == ctx).all():
                    return row[ctx.size:ctx.size + k]
            return np.empty((0,), np.int64)

    return Oracle()


def count_verify_passes(eng):
    """Wrap the engine's verify scan to count what a block dispatches:
    passes, the megakernel launches they take in "multi" mode (ceil(w /
    floor(8 / T)) per pass at slot width w) and those of sampled blocks
    (the top-K fold). `del eng._spec_scan` before dropping the engine."""
    from paddle_tpu_torch.ops.pallas.decode_megakernel import MAX_ROWS
    counter = dict(passes=0, mk=0, fold=0)
    scan = eng._spec_scan

    def counted(tables, tok, lens, act, rem, eos, drafts, dlen, mode="greedy", ex=None):
        n = drafts.shape[0]
        per = -(-tok.shape[0] // (MAX_ROWS // eng._spec))
        counter["passes"] += n
        counter["mk"] += n * per
        counter["fold"] += n * per if mode == "sampled" else 0
        return scan(tables, tok, lens, act, rem, eos, drafts, dlen, mode, ex)

    eng._spec_scan = counted
    return counter


def first_divergence_margins(torch, model, geom, prompts, ref, outs, tol):
    """The margin rule where two greedy streams part: for each request, the
    first generated position where `outs` differs from `ref`, and the top-2
    margin of the bf16 logits there (a static engine's prefill over the
    shared prefix). Every earlier token is equal; the rule holds when each
    first divergence sits on a margin <= tol."""
    from paddle_tpu_torch.inference.serving import LLMEngine
    eng = LLMEngine(model, max_len=geom["max_len"], page_size=geom["page_size"],
                    max_batch=1, weight_dtype="bfloat16", device=geom["device"])
    parts = []
    for p, r, o in zip(prompts, ref, outs):
        diff = [t for t in range(p.size, min(r.size, o.size)) if r[t] != o[t]]
        if diff:
            t = diff[0]
            top2 = torch.topk(eng.prefill_logits(r[None, :t])[0], 2).values
            parts.append(dict(pos=t - p.size, margin=float(top2[0] - top2[1])))
    del eng
    torch.cuda.empty_cache()
    return parts, all(d["margin"] <= tol for d in parts)


def spec_cb_runs(torch, model, geom, prompts, budgets, streams, launches):
    """The cb_stream at speculate=4, K=8, 7B at full width and depth (the
    slice's own path): greedy "multi" with the n-gram and the oracle
    drafter, the greedy op chain with the n-gram drafter, and the sampled
    stream of cb_sampled in "multi" with the n-gram drafter. Gates: "multi"
    ids (greedy and sampled) equal the unspeculated run's exactly; the op
    chain is held by the margin rule (tokens equal up to each request's
    first divergence, which must sit on a top-2 margin <= 0.1); the oracle
    accepts (nearly) every draft; exact launch counts (ceil(w / 2)
    megakernel launches per pass in "multi", 32 spec_verify_attention
    launches per pass on the op chain, no paged attention); every request
    finishes its budget; no page leaks. Reports ms per verify pass,
    generated tok/s, tokens per pass and the acceptance rate."""
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    import numpy as np

    L, V = model.config.num_hidden_layers, model.config.vocab_size
    T, tol = SPEC_T, 0.1
    rows = []
    for name, mk, dname, sampled, refname in SPEC_RUNS:
        ref = streams[refname]
        drafter = oracle_drafter(ref) if dname == "oracle" else dname
        eng = ContinuousBatchingEngine(model, decode_block=8, megakernel=mk, speculate=T,
                                       drafter=drafter, sample_k=8, **geom)
        count = count_verify_passes(eng)
        specs = sampled_specs(len(prompts)) if sampled else None
        torch.cuda.synchronize()
        reset_kernel_launches()
        outs, wall, pass_ms = drive_cb(torch, eng, prompts, budgets, specs)
        counts = kernel_launches()
        h = eng.health()
        gen = int(sum(o.size - p.size for o, p in zip(outs, prompts)))
        n = count["passes"]
        if mk == "multi":
            launch_ok = (counts["decode_megakernel"] == count["mk"]
                         and counts["decode_megakernel_verify"] == count["mk"]
                         and counts["decode_megakernel_topk"] == count["fold"]
                         and counts["spec_verify_attention"] == 0)
        else:
            launch_ok = (counts["spec_verify_attention"] == L * n
                         and counts["decode_megakernel"] == 0)
        launch_ok = (launch_ok and n > 0 and counts["paged_attention"] == 0
                     and counts["spec_verify_attention_staged"]
                     == counts["spec_verify_attention"]
                     and counts["ragged_paged_attention"] % L == 0
                     and tc_prefill(counts)
                     and (counts["decode_megakernel_topk"] > 0) == sampled)
        same = sum(int((o[p.size:] == r[p.size:]).sum())
                   for o, r, p in zip(outs, ref, prompts))
        exact = all(np.array_equal(o, r) for o, r in zip(outs, ref))
        row = dict(run=name, decode_block=8, speculate=T, drafter=h["drafter"],
                   megakernel=h["megakernel"], requests=len(prompts),
                   sampled_requests=h["sampled_requests"], generated_tokens=gen,
                   wall_s=wall, generated_tokens_per_s=gen / wall,
                   ms_per_verify_pass=pass_ms, verify_passes=n,
                   spec_passes=h["spec_passes"],
                   spec_tokens_per_pass=h["spec_tokens_per_pass"],
                   spec_accept_rate=h["spec_accept_rate"],
                   spec_sampled_accept_rate=h["spec_sampled_accept_rate"],
                   draft_errors=h["draft_errors"], launches=counts,
                   expected=dict(passes=n, megakernel=count["mk"], fold=count["fold"],
                                 spec_verify_attention=L * n if not mk else 0),
                   launches_ok=launch_ok, unspeculated_run=refname,
                   tokens_equal_to_unspeculated=same / gen, ids_equal_unspeculated=exact,
                   budgets_met=all(o.size == p.size + b for o, p, b in zip(outs, prompts,
                                                                           budgets)),
                   all_finished=h["done"] == len(prompts),
                   no_leak=h["pages_free"] + h["prefix_pages"] == h["pages_total"],
                   tail=outs[0][-4:].tolist())
        del eng._spec_scan, eng
        torch.cuda.empty_cache()
        if mk == "multi":
            held = exact
        else:
            row["divergences"], held = first_divergence_margins(
                torch, model, geom, prompts, ref, outs, tol)
            row["margin_tol"] = tol
        row["held"] = held
        row["ok"] = (held and launch_ok and row["budgets_met"] and row["all_finished"]
                     and row["no_leak"] and row["draft_errors"] == 0
                     and (dname != "oracle" or h["spec_accept_rate"] >= 0.99))
        rows.append(row)
        for kname, c in counts.items():
            launches[kname] = launches.get(kname, 0) + c
    return rows


# tp_path: the cb_stream on ContinuousBatchingEngine(tp=2) with both shards
# on one card, K=8 (name, quant, megakernel, sampled, tp_mode, tp_compress,
# the tp = 1 stream of cb_path / cb_sampled it is held against, and the rule:
# "exact" ids, the first-divergence "margin" rule, or only the "share" of
# equal ids for the psum modes, whose sums associate differently)
TP = 2
TP_RUNS = (
    ("tp2 multi K=8 bf16", None, "multi", False, "exact", None, "multi K=8 bf16", "exact"),
    ("tp2 multi K=8 int8", "int8", "multi", False, "exact", None, "multi K=8 int8",
     "exact"),
    ("tp2 layer K=8 bf16", None, "layer", False, "exact", None, "layer K=8 bf16", "exact"),
    ("tp2 K=8 int8", "int8", False, False, "exact", None, "K=8 int8", "exact"),
    ("tp2 K=8 bf16", None, False, False, "exact", None, "K=8 bf16", "margin"),
    ("tp2 sampled multi K=8 bf16", None, "multi", True, "exact", None,
     "sampled multi K=8 bf16", "exact"),
    ("tp2 psum K=8 bf16", None, False, False, "psum", None, "K=8 bf16", "share"),
    ("tp2 psum int8-wire K=8 bf16", None, False, False, "psum", "int8", "K=8 bf16",
     "share"))


def tp_cb_runs(torch, model, geom, prompts, budgets, streams, launches):
    """The cb_stream through ContinuousBatchingEngine(tp=2, device=[card,
    card]) at 7B full width and depth, K=8, cb_path's settings (TP_RUNS),
    then LLMEngine(tp=2).generate(device_loop=True) on 4 x 12 prompts.
    Gates: ids against the tp = 1 run of the same mode (TP_RUNS' rule: the
    megakernel modes and the int8 op chain exactly; the bf16 op chain, whose
    cuBLAS products run on sliced widths, by the first-divergence margin
    rule at 0.1; psum only reported); exact launch counts (the megakernel:
    3 L tp segment launches per decode micro-step, the fold tp per sampled
    micro-step; the op chain: paged attention L tp per micro-step, ragged
    L tp per prefill block, int8 matmuls (7 L + 1) tp per prefill block and
    decode micro-step); budgets met, no page leaked. Times are tp shards run
    one after another on one card."""
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.serving import LLMEngine
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    import numpy as np

    L, V = model.config.num_hidden_layers, model.config.vocab_size
    dev = geom["device"]
    tgeom = dict(geom, device=[dev] * TP)
    specs = sampled_specs(len(prompts))
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    rows = []
    for name, quant, mk, sampled, mode, comp, refname, rule in TP_RUNS:
        eng = ContinuousBatchingEngine(model, decode_block=8, quant=quant, megakernel=mk,
                                       tp=TP, tp_mode=mode, tp_compress=comp,
                                       sample_k=8, **tgeom)
        steps = count_sampled_steps(eng)
        torch.cuda.synchronize()
        reset_kernel_launches()
        outs, wall, dec_ms = drive_cb(torch, eng, prompts, budgets,
                                      specs if sampled else None)
        counts = kernel_launches()
        h = eng.health()
        dec = h["decode_steps"]
        n_pf = counts["ragged_paged_attention"] // (L * TP)
        gen = int(sum(o.size - p.size for o, p in zip(outs, prompts)))
        expect = dict(decode_megakernel=3 * L * TP * dec if mk else 0,
                      decode_megakernel_tp=3 * L * TP * dec if mk else 0,
                      decode_megakernel_topk=TP * steps["sampled"] if mk else 0,
                      paged_attention=0 if mk else L * TP * dec,
                      paged_attention_staged=0 if mk else L * TP * dec,
                      quantized_matmul=(7 * L + 1) * TP * (n_pf + (0 if mk else dec))
                      if quant else 0)
        launch_ok = (all(counts[k] == v for k, v in expect.items())
                     and dec > 0 and n_pf > 0
                     and counts["ragged_paged_attention"] == L * TP * n_pf
                     and tc_prefill(counts)
                     and (steps["sampled"] > 0) == sampled)
        ref = streams[refname]
        same = sum(int((o[p.size:] == r[p.size:]).sum())
                   for o, r, p in zip(outs, ref, prompts))
        exact = all(np.array_equal(o, r) for o, r in zip(outs, ref))
        row = dict(run=name, tp=TP, devices=[str(dev)] * TP, tp_mode=h["tp_mode"],
                   tp_compress=h["tp_compress"], decode_block=8, weights=quant or "bf16",
                   megakernel=h["megakernel"], requests=len(prompts),
                   sampled_requests=h["sampled_requests"], generated_tokens=gen,
                   wall_s=wall, generated_tokens_per_s=gen / wall,
                   ms_per_decode_microstep=dec_ms, decode_steps=dec, prefill_blocks=n_pf,
                   launches=counts, expected=expect, launches_ok=launch_ok,
                   tp1_run=refname, tokens_equal_to_tp1=same / gen, ids_equal_tp1=exact,
                   rule=rule,
                   budgets_met=all(o.size == p.size + b
                                   for o, p, b in zip(outs, prompts, budgets)),
                   all_finished=h["done"] == len(prompts),
                   ids_in_vocab=all(bool(((o >= 0) & (o < V)).all()) for o in outs),
                   no_leak=h["pages_free"] + h["prefix_pages"] == h["pages_total"],
                   tail=outs[0][-4:].tolist())
        del eng._decode_scan, eng
        torch.cuda.empty_cache()
        if rule == "exact":
            held = exact
        elif rule == "margin":
            row["divergences"], held = first_divergence_margins(
                torch, model, geom, prompts, ref, outs, 0.1)
            row["margin_tol"] = 0.1
        else:
            held = True               # reported, not gated: psum is close only
        row["held"] = held
        row["ok"] = (held and launch_ok and row["budgets_met"] and row["all_finished"]
                     and row["ids_in_vocab"] and row["no_leak"])
        rows.append(row)
        for kname, c in counts.items():
            launches[kname] = launches.get(kname, 0) + c
    # the static engine: one batch of 4 x 12 prompts, device loop, bf16
    rng = np.random.RandomState(0)
    ids = rng.randint(0, V, (4, 12)).astype(np.int64)
    n_new = 16
    kw = dict(max_len=512, page_size=64, max_batch=4, weight_dtype="bfloat16")
    one = LLMEngine(model, device=dev, **kw).generate(ids, max_new_tokens=n_new,
                                                      device_loop=True)
    eng = LLMEngine(model, tp=TP, device=[dev] * TP, **kw)
    eng.generate(ids, max_new_tokens=n_new, device_loop=True)   # warm-up
    torch.cuda.synchronize()
    reset_kernel_launches()
    t = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=n_new, device_loop=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = kernel_launches()
    n_loop = min(-(-(n_new - 1) // 32) * 32, eng.max_len - ids.shape[1] - 1)
    del eng
    torch.cuda.empty_cache()
    divs, held = first_divergence_margins(torch, model, geom, list(ids), list(one),
                                          list(out), 0.1)
    row = dict(run="tp2 static generate device_loop 4x12 bf16", tp=TP,
               new_tokens=n_new, wall_s=wall, ms_per_step=1e3 * wall / (1 + n_loop),
               generated_tokens_per_s=4 * n_new / wall, launches=counts,
               expected_paged_attention=L * TP * n_loop,
               launches_ok=(counts["paged_attention"] == L * TP * n_loop
                            and counts["paged_attention_staged"] == L * TP * n_loop
                            and counts["flash_attention_fwd"] == 0
                            and counts["decode_megakernel"] == 0),
               tokens_equal_to_tp1=float((out[:, 12:] == one[:, 12:]).mean()),
               divergences=divs, margin_tol=0.1, held=held, tail=out[0, -4:].tolist())
    row["ok"] = row["launches_ok"] and held and out.shape == (4, 12 + n_new)
    rows.append(row)
    for kname, c in counts.items():
        launches[kname] = launches.get(kname, 0) + c
    return dict(runs=rows, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                seconds=time.perf_counter() - t_phase)


def proc_vocab(V):
    """Synthetic token strings for the grammar run: digits, brackets, a
    comma and a minus at ids 100-113, a few multi-character tokens, and
    random lowercase words elsewhere (ids 0-2 empty: unk, bos, eos)."""
    import numpy as np
    rng = np.random.RandomState(3)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    toks = ["".join(rng.choice(letters, rng.randint(1, 5))) for _ in range(V)]
    toks[0] = toks[1] = toks[2] = ""
    for d in range(10):
        toks[100 + d] = str(d)
    toks[110:114] = ["[", "]", ",", "-"]
    toks[114:118] = ["12", "],", "[1", "0]"]
    return toks


def proc_run(torch, model, geom, launches):
    """One request through the processor chain at 7B width ("multi" bf16,
    K=8): repetition_penalty 1.2 and a grammar, a TokenMaskAutomaton of the
    JSON schema {"type": "array", "items": {"type": "integer"}, "maxItems":
    3} over proc_vocab. Gates: every emitted token is allowed by the
    automaton from the state before it, EOS only in an accepting state, the
    same ids on a second run, no chained block (proc blocks never chain)."""
    from paddle_tpu_torch.inference.sampling import SamplingParams, TokenMaskAutomaton
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    import numpy as np

    V = model.config.vocab_size
    toks = proc_vocab(V)
    t = time.perf_counter()
    auto = TokenMaskAutomaton.from_json_schema(
        {"type": "array", "items": {"type": "integer"}, "maxItems": 3}, toks, eos_id=2)
    build_s = time.perf_counter() - t
    eng = ContinuousBatchingEngine(model, decode_block=8, megakernel="multi", **geom)
    prompt = np.random.RandomState(4).randint(3, V, 40).astype(np.int64)
    sp = SamplingParams(do_sample=True, temperature=0.8, seed=7, repetition_penalty=1.2,
                        grammar=auto)
    outs = []
    reset_kernel_launches()
    for _ in range(2):
        u = eng.add_request(prompt, 24, eos_token_id=2, sampling=sp)
        eng.drain()
        outs.append(eng.result(u))
    counts = kernel_launches()
    for kname, c in counts.items():
        launches[kname] = launches.get(kname, 0) + c
    gen = outs[0][prompt.size:]
    state, allowed, eos_ok, text = 0, True, True, ""
    for tok in gen.tolist():
        if not auto.mask[state, tok]:
            allowed = False
            break
        if tok == 2:
            eos_ok = state in auto.accept_states
            break
        text += toks[tok]
        state = auto.advance(state, tok)
    h = eng.health()
    row = dict(run="proc multi K=8 bf16", automaton_states=auto.n_states,
               automaton_build_s=build_s, generated=gen.tolist(), text=text,
               all_allowed=allowed, eos_in_accept_state=eos_ok,
               repeat_identical=bool(np.array_equal(outs[0], outs[1])),
               chained_blocks=h["chained_blocks"], launches=counts,
               no_leak=h["pages_free"] + h["prefix_pages"] == h["pages_total"])
    row["ok"] = (allowed and eos_ok and row["repeat_identical"] and h["chained_blocks"] == 0
                 and counts["decode_megakernel_topk"] == 0
                 and counts["decode_megakernel"] == h["decode_steps"]
                 and row["no_leak"] and h["done"] == 2)
    del eng
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------- phase 7
def parity_cb_2layer(torch, dev):
    """The CB engine on the card (bf16, K=8, kernels; the op chain and the
    "multi" megakernel) against the same weights in the CPU CB engine (f32,
    plain versions) on 4 ragged requests; greedy ids compared wherever the
    CPU's top-2 margin (from the static CPU engine's prefill_logits) exceeds
    the tolerance. Returns one row per card run."""
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.serving import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    import numpy as np

    cfg = LlamaConfig(hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=2, num_attention_heads=32)   # 7B width
    model = LlamaForCausalLM(cfg, device="cpu", seed=7)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, t).astype(np.int64)
               for t in (12, 300, 140, 65)]
    n_new = 8
    tol = 0.1     # as phase 5: bf16 on the card against f32 on the CPU
    kw = dict(max_len=512, page_size=64, max_batch=4, prefill_chunk=128,
              decode_block=8)
    outs_cpu = ContinuousBatchingEngine(model, device="cpu", **kw).generate_many(
        prompts, max_new_tokens=n_new)
    ref = LLMEngine(model, device="cpu", max_len=512, page_size=64, max_batch=1)
    margins = [[float(torch.topk(ref.prefill_logits(oc[None, :p.size + t])[0], 2)
                      .values.diff().neg()) for t in range(n_new)]
               for p, oc in zip(prompts, outs_cpu)]
    rows = []
    # the spec leg: the CPU spec engine's ids must equal the CPU stream's
    cpu_spec = ContinuousBatchingEngine(model, device="cpu", speculate=SPEC_T, **kw)
    spec_cpu_equal = all(np.array_equal(a, b) for a, b in zip(
        cpu_spec.generate_many(prompts, max_new_tokens=n_new), outs_cpu))
    del cpu_spec
    for mk, spec, tp in ((False, None, 1), ("multi", None, 1), ("multi", SPEC_T, 1),
                         ("multi", None, 2)):
        gpu = ContinuousBatchingEngine(model, device=dev if tp == 1 else [dev] * tp,
                                       weight_dtype="bfloat16", megakernel=mk,
                                       speculate=spec, tp=tp, **kw)
        outs_gpu = gpu.generate_many(prompts, max_new_tokens=n_new)
        compared = equal = 0
        for p, oc, og, mg in zip(prompts, outs_cpu, outs_gpu, margins):
            t0 = p.size
            for t in range(n_new):
                same = oc[t0 + t] == og[t0 + t]
                if mg[t] > tol:
                    compared += 1
                    equal += int(same)
                if not same:
                    break
        row = dict(megakernel=gpu.health()["megakernel"], speculate=spec or 0, tp=tp,
                   requests=len(prompts), prompt_lens=[int(p.size) for p in prompts],
                   tol=tol, greedy_compared=compared, greedy_equal=equal,
                   ok=compared > 0 and equal == compared)
        if spec:
            row["cpu_spec_ids_equal_cpu"] = spec_cpu_equal
            row["spec_tokens_per_pass"] = gpu.health()["spec_tokens_per_pass"]
            row["ok"] = row["ok"] and spec_cpu_equal
        rows.append(row)
        del gpu
        torch.cuda.empty_cache()
    return rows


def parity_cb_sampled(torch, dev):
    """The sampled CB stream on the card (bf16, "multi", the top-K fold,
    K=8) against the same weights in the CPU CB engine (f32, plain
    versions), 2 layers at 7B width, 8 ragged requests, all sampled. The
    margin rule of parity_cb_2layer carried to a draw: a token is compared
    where the CPU's draw (from the static CPU engine's prefill_logits at
    its key) is unchanged when every logit moves by up to tol / 2, tried
    with 32 seeded perturbations (a draw's Gumbel noise belongs to a rank,
    so near-equal candidates that swap ranks swap noise too: a gap between
    two selection scores alone does not decide it); a request is followed
    until the runs part. Also reports the share of generated tokens equal
    position by position."""
    from paddle_tpu_torch.inference.sampling import fold_keys, selection_scores, top_k
    from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
    from paddle_tpu_torch.inference.serving import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    import numpy as np

    cfg = LlamaConfig(hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=2, num_attention_heads=32)   # 7B width
    model = LlamaForCausalLM(cfg, device="cpu", seed=7)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, t).astype(np.int64)
               for t in (12, 300, 140, 65, 33, 200, 90, 7)]
    specs = [dict(do_sample=True, temperature=0.8, top_p=0.9, min_p=0.05, top_k=8,
                  seed=2000 + i) for i in range(len(prompts))]
    n_new, tol = 8, 0.1       # tol as phase 7, in logit units
    kw = dict(max_len=512, page_size=64, max_batch=4, prefill_chunk=128,
              decode_block=8, megakernel="multi", sample_k=8)
    cpu = ContinuousBatchingEngine(model, device="cpu", **kw)
    outs_cpu, _, _ = drive_cb(torch, cpu, prompts, [n_new] * len(prompts), specs)
    ref = LLMEngine(model, device="cpu", max_len=512, page_size=64, max_batch=1)

    def decided(lg, sp, pos, trials=32):
        v, ids = top_k(lg, 64)          # a move of tol / 2 reaches no further
        n = trials + 1
        keys = fold_keys(torch.full((n,), sp["seed"]), torch.full((n,), pos))
        g = torch.Generator().manual_seed(pos)
        vals = v.float() + torch.cat([torch.zeros((1, 64)),
                                      (torch.rand((trials, 64), generator=g) - 0.5) * tol])
        tv, ti = top_k(vals, 8)
        sc = selection_scores(tv, keys, torch.full((n,), sp["temperature"]),
                              torch.full((n,), sp["top_k"]), torch.full((n,), sp["top_p"]),
                              torch.full((n,), sp["min_p"]))
        picks = ids.expand(n, -1).gather(1, ti.gather(1, sc.argmax(-1, keepdim=True)))
        return bool((picks == picks[0]).all())

    decided_at = [[decided(ref.prefill_logits(oc[None, :p.size + t]), sp, p.size + t)
                   for t in range(n_new)] for p, oc, sp in zip(prompts, outs_cpu, specs)]
    gpu = ContinuousBatchingEngine(model, device=dev, weight_dtype="bfloat16", **kw)
    reset_kernel_launches()
    outs_gpu, _, _ = drive_cb(torch, gpu, prompts, [n_new] * len(prompts), specs)
    fold = kernel_launches()["decode_megakernel_topk"]
    compared = equal = same_all = 0
    for p, oc, og, dec in zip(prompts, outs_cpu, outs_gpu, decided_at):
        t0 = p.size
        same_all += int((oc[t0:] == og[t0:]).sum())
        for t in range(n_new):
            same = oc[t0 + t] == og[t0 + t]
            if dec[t]:
                compared += 1
                equal += int(same)
            if not same:
                break
    row = dict(weights="bf16", megakernel=gpu.health()["megakernel"], requests=len(prompts),
               prompt_lens=[int(p.size) for p in prompts], tol=tol, fold_launches=fold,
               sampled_compared=compared, sampled_equal=equal,
               share_equal=same_all / (n_new * len(prompts)),
               ok=fold > 0 and compared > 0 and equal == compared)
    del gpu
    torch.cuda.empty_cache()
    return [row]


# ---------------------------------------------------------------- phase 8
TRAIN_RUNS = (
    # config, warmup, timed steps, exact kernel launches per step
    # llama350m, save_attn: 16 forward attentions (the recompute replays
    # their o and lse), 16 backward, norms 2 x 16 + 1 forward and 2 x 16
    # again in the recompute; every flash launch on its bf16 tensor-core
    # build
    ("llama350m", 3, 10, {"flash_attention_fwd": 16, "flash_attention_fwd_tc": 16,
                          "flash_attention_bwd": 16, "flash_attention_bwd_tc": 16,
                          "rms_norm": 65}),
    # llama1p3b, full: every layer's forward runs again in backward
    ("llama1p3b", 2, 5, {"flash_attention_fwd": 48, "flash_attention_fwd_tc": 48,
                         "flash_attention_bwd": 24, "flash_attention_bwd_tc": 24,
                         "rms_norm": 97}),
)


# gpt3_1p3b, full recompute, dropout 0.1: every attention forward (24,
# then 24 again in the recompute) and backward (24) has dropout
GPT_TRAIN_RUNS = (
    ("gpt3_1p3b", 2, 5, {"flash_attention_fwd": 48, "flash_attention_fwd_tc": 48,
                         "flash_attention_bwd": 24, "flash_attention_bwd_tc": 24,
                         "flash_attention_fwd_dropout": 48,
                         "flash_attention_bwd_dropout": 24}),
)


def mask_draw_ms(torch, dev, shape=(8, 1024, 2048)):
    """Device time of one hidden-dropout keep mask of gpt3_1p3b's
    activations, drawn afresh (float64 uniforms from threefry in eager
    int64 ops; the trainer draws each distinct mask once per step)."""
    from paddle_tpu_torch.framework import random as frnd
    key = frnd.key(1)
    return time_ms(torch, lambda: frnd.bernoulli(key, 0.9, shape, dev), iters=3, warmup=1)


def train_path(torch, dev, runs=TRAIN_RUNS):
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.train_llama import run_config
    results, launches = [], {}
    for name, warmup, steps, per_step in runs:
        torch.cuda.empty_cache()
        reset_kernel_launches()
        r = run_config(name, steps=steps, warmup=warmup, device=dev, profile=True)
        counts = kernel_launches()
        n = warmup + steps + (r["profile"] is not None)   # the profiled step
        expect = {k: per_step.get(k, 0) * n for k in counts}
        losses = r["losses"]
        finite = all(math.isfinite(x) for x in losses)
        ok = finite and losses[-1] < losses[0] and counts == expect
        results.append(dict(r, launches=counts, expected_launches=expect,
                            launches_per_step={k: c / n for k, c in counts.items()},
                            losses_finite=finite, loss_fell=losses[-1] < losses[0],
                            ok=ok))
        for kname, c in counts.items():
            launches[kname] = launches.get(kname, 0) + c
        torch.cuda.empty_cache()
    return results, launches


# ---------------------------------------------------------------- phase 9
def param_gate(params, ref_params, bf16, lr, steps):
    """The parameters after `steps` optimizer steps on the card against
    the CPU's, element by element: |p - ref| <= limit. In f32 the limit is
    1e-4 (the card's sums in another order; one step of lr 1e-4 moves a
    parameter by up to 1e-4, so a skipped or wrong update shows); in bf16
    it is 2^-7 |ref| (two roundings to bf16, at load and after the last
    step, each within half an ulp, 2^-8 of the value) plus 3 x steps x lr
    (Adam's step is about lr whatever the gradient, so bf16 gradients may
    move a parameter up to 2 lr a step away). The attention key biases get
    3 x steps x lr in f32 too: their gradient is zero in exact arithmetic
    (softmax is shift invariant), so Adam moves them by noise. Returns the
    worst |p - ref| / limit (<= 1 passes) and the parameter's name."""
    worst, at = 0.0, None
    drift = 3 * steps * lr
    for n, ref in ref_params.items():
        d = (params[n] - ref).abs()
        if bf16:
            limit = ref.abs() * 2.0 ** -7 + drift
        else:
            limit = drift if n.endswith("k_proj.bias") else 1e-4
        r = float((d / limit).max())
        if not r <= worst:
            worst, at = r, n
    return worst, at


def train_parity(torch, dev, make_model=None, keys=(None, None, None)):
    """The trainer on the card against the trainer on the CPU (f32, plain
    versions) from one state: 2 layers at the 350m width and vocab (or
    `make_model(device)`'s), bs 4, seq 256, 3 steps, recompute save_attn,
    lr 1e-4, step i keyed by keys[i]."""
    import numpy as np
    from paddle_tpu_torch.models import SpmdTrainer
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    if make_model is None:
        cfg = LlamaConfig(vocab_size=32000, hidden_size=1024, intermediate_size=2816,
                          num_hidden_layers=2, num_attention_heads=16,
                          max_position_embeddings=1024)

        def make_model(device):
            return LlamaForCausalLM(cfg, device=device, seed=5)

    cpu_model = make_model("cpu")
    rng = np.random.RandomState(1)
    ids = rng.randint(0, cpu_model.config.vocab_size, (4, 256)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    lr = 1e-4
    kw = dict(lr=lr, recompute=True, recompute_policy="save_attn")

    def run(device, **extra):
        model = make_model(device)
        model.load_state_dict(cpu_model.state_dict())
        tr = SpmdTrainer(model, **kw, **extra)
        st = tr.init_state()
        losses = []
        for key in keys:
            st, loss = tr.step(st, ids, labels, key=key)
            losses.append(float(loss))
        return losses, {n: t.float().cpu() for n, t in st["params"].items()}

    ref_losses, ref_params = run("cpu")
    rows = []
    # f32 on the card, TF32 off: the same math in another summation order;
    # bf16 on the card: bf16 params, activations and products against f32
    for name, extra, tol in (("f32", dict(param_dtype="float32"), 1e-3),
                             ("bf16", dict(param_dtype="bfloat16"), 2e-2)):
        losses, params = run(dev, **extra)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        pdiff = max(float((params[n] - ref_params[n]).abs().max()) for n in ref_params)
        pratio, pname = param_gate(params, ref_params, name == "bf16", lr, len(keys))
        rows.append(dict(card=name, cpu="f32", model=type(cpu_model).__name__,
                         losses=losses, cpu_losses=ref_losses,
                         loss_max_rel_diff=rel, tol=tol, param_max_abs_diff=pdiff,
                         param_worst_over_limit=pratio, param_worst=pname,
                         ok=rel <= tol and pratio <= 1
                         and all(math.isfinite(x) for x in losses)))
        torch.cuda.empty_cache()
    return rows


def gpt_train_parity(torch, dev):
    """train_parity on GPT: 2 layers at the gpt3_1p3b width and vocab,
    dropout 0.1 (hidden and attention) on both sides, step i keyed by
    key(100 + i): the card's masks are the CPU's bits (the flash kernels'
    hash and the plain `dropout_keep`, one threefry stream)."""
    from paddle_tpu_torch.framework import random as frnd
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(hidden_size=2048, num_hidden_layers=2, num_attention_heads=16)
    return train_parity(torch, dev, lambda device: GPTForCausalLM(cfg, device=device, seed=5),
                        keys=[frnd.key(100 + i) for i in range(3)])


# ---------------------------------------------------------------- phase 12
# BertForMaskedLM(BertConfig.base()) through paddle_tpu_torch.train_bert:
# f32 (the reference's default dtype), then bf16 parameters under
# AdamW(multi_precision=True); every step launches each flash kernel once
# per layer (12), every launch with the padding mask, non-causal and with
# attention dropout; the bf16 run's launches take the tensor-core builds
# ("flash_attention_fwd_tc", "flash_attention_bwd_tc")
BERT_TRAIN_RUNS = (("float32", 2, 5), ("bfloat16", 2, 5))
BERT_PER_STEP = {f"flash_attention_{kind}{branch}": 12 for kind in ("fwd", "bwd")
                 for branch in ("", "_dropout", "_masked", "_noncausal")}


def bert_train_path(torch, dev):
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.train_bert import run_bert
    results, launches = [], {}
    for dtype, warmup, steps in BERT_TRAIN_RUNS:
        torch.cuda.empty_cache()
        reset_kernel_launches()
        r = run_bert("base", dtype, steps, warmup, dev, profile=True)
        counts = kernel_launches()
        n = warmup + steps + (r["profile"] is not None)   # the profiled step
        tc = 12 if dtype == "bfloat16" else 0
        per_step = dict(BERT_PER_STEP, flash_attention_fwd_tc=tc, flash_attention_bwd_tc=tc)
        expect = {k: per_step.get(k, 0) * n for k in counts}
        losses = r["losses"]
        finite = all(math.isfinite(x) for x in losses)
        ok = finite and losses[-1] < losses[0] and counts == expect
        results.append(dict(r, launches=counts, expected_launches=expect,
                            launches_per_step={k: c / n for k, c in counts.items()},
                            losses_finite=finite, loss_fell=losses[-1] < losses[0],
                            ok=ok))
        for kname, c in counts.items():
            launches[kname] = launches.get(kname, 0) + c
        torch.cuda.empty_cache()
    return results, launches


# ---------------------------------------------------------------- phase 13
def bert_train_parity(torch, dev):
    """BertForMaskedLM at the base width, 2 layers, batch 4 x 128 with
    padding (`train_bert.mlm_batch`), 3 AdamW(1e-4) steps, dropout 0.1: the
    card (f32 with TF32 off; bf16 parameters with multi_precision) against
    the CPU (f32, plain versions) from the same weights, the global
    generator seeded alike on both sides, so every dropout mask and flash
    seed is the same bits."""
    from paddle_tpu_torch.framework import random as frnd
    from paddle_tpu_torch.train_bert import build, mlm_batch
    cpu_model, _ = build("base", "float32", "cpu", seed=5, num_hidden_layers=2)
    batch = mlm_batch(cpu_model.config, 4, 128, seed=1)
    weights = cpu_model.state_dict()

    def run(device, dtype):
        model, opt = build("base", dtype, device, seed=5, num_hidden_layers=2)
        model.load_state_dict(weights)
        ids, tt, am, labels = (torch.from_numpy(a).to(device) for a in batch)
        frnd.seed(7)
        losses = []
        for _ in range(3):
            loss = model(ids, tt, am, labels=labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
        return losses, {n: p.detach().float().cpu() for n, p in model.named_parameters()}

    ref_losses, ref_params = run(torch.device("cpu"), "float32")
    rows = []
    # f32 on the card, TF32 off: the same math in another summation order;
    # bf16 on the card: bf16 weights and activations against f32
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
        losses, params = run(dev, dtype)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        pdiff = max(float((params[n] - ref_params[n]).abs().max()) for n in ref_params)
        pratio, pname = param_gate(params, ref_params, dtype == "bfloat16", 1e-4,
                                   len(losses))
        rows.append(dict(card=dtype, cpu="float32", model="BertForMaskedLM",
                         layers=2, losses=losses, cpu_losses=ref_losses,
                         loss_max_rel_diff=rel, tol=tol, param_max_abs_diff=pdiff,
                         param_worst_over_limit=pratio, param_worst=pname,
                         ok=rel <= tol and pratio <= 1
                         and all(math.isfinite(x) for x in losses)))
        torch.cuda.empty_cache()
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
        from paddle_tpu_torch import _build
        from paddle_tpu_torch.ops import reset_kernel_launches
    except ImportError as e:
        print(f"chip_smoke: paddle_tpu_torch is not importable ({e}); run from "
              "the repository root", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    ok = True
    t_start = time.perf_counter()

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "n/a"
    print(smi_line, flush=True)
    emit(dict(phase="device", name=torch.cuda.get_device_name(0), smi=smi_line,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0], tf32=False))

    # 2. build
    t = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t
    ptxas = ptxas_summary(_build.build_log() or "")
    sass = sass_mma_counts(_build.build_info()["path"])
    emit(dict(phase="build", seconds=build_s, path=_build.build_info()["path"],
              ptxas=ptxas, tensor_core_sass=sass, ok=tc_sass_ok(sass)))
    ok &= tc_sass_ok(sass)

    # 3. kernels
    main_rows = {}
    checks = (("quantized_matmul", check_quantized_matmul),
              ("paged_attention", check_paged_attention),
              ("flash_attention_fwd", check_flash),
              ("ragged_paged_attention", check_ragged),
              ("rms_norm", check_rms), ("flash_attention_bwd", check_flash_bwd),
              ("decode_megakernel", check_megakernel),
              ("decode_megakernel_topk",
               lambda torch, dev: check_megakernel_topk(torch, dev, ptxas)),
              ("spec_verify_attention", check_spec_verify),
              ("decode_megakernel_verify",
               lambda torch, dev: check_megakernel_verify(torch, dev, ptxas)),
              ("decode_megakernel_tp",
               lambda torch, dev: check_megakernel_tp(torch, dev, ptxas)),
              ("flash_attention_fwd_dropout", check_flash_dropout),
              ("flash_attention_bwd_dropout", check_flash_bwd_dropout),
              ("flash_attention_fwd_masked", check_flash_masked),
              ("flash_attention_bwd_masked", check_flash_bwd_masked))
    all_rows = {}
    for name, check in checks:
        with watchdog(f"kernels {name}", KERNEL_PHASE_S):
            rows = all_rows[name] = check(torch, dev)
        for r in rows:
            emit(dict(phase="kernels", kernel=name, **r))
            ok &= r["ok"]
        # the row at the main path's shape (the first with a time;
        # quantized_matmul: the decode GEMV of gate/up; the fold: 8 slots
        # at sample_k 8 in bf16, the cb_sampled stream's)
        main_rows[name] = next(r for r in rows if "ms" in r and (
            name != "quantized_matmul" or (r["m"] == 4 and r["n"] == 11008)) and (
            name != "decode_megakernel_topk" or (r["R"] == 8 and r["head_k"] == 8)) and (
            name != "decode_megakernel_tp" or (r["tp"] == 2 and r["R"] == 8
                                               and r["weights"] == "bf16")))
    main_rows["paged_attention_staged"] = main_rows["paged_attention"]
    main_rows["spec_verify_attention_staged"] = main_rows["spec_verify_attention"]
    main_rows["ragged_paged_attention_tc"] = main_rows["ragged_paged_attention"]
    main_rows["flash_attention_bwd_tc"] = main_rows["flash_attention_bwd"]
    main_rows["flash_attention_bwd_f32"] = next(
        r for r in all_rows["flash_attention_bwd_masked"] if r["case"] == "bert_base_f32")
    main_rows["flash_attention_fwd_tc"] = main_rows["flash_attention_fwd"]
    main_rows["flash_attention_fwd_f32"] = next(
        r for r in all_rows["flash_attention_fwd_masked"] if r["case"] == "bert_base_f32")
    with watchdog("kernels flash_attention_mask_gates", KERNEL_PHASE_S):
        gates = flash_mask_gates(torch, dev)
    for r in gates:
        emit(dict(phase="kernels", kernel="flash_attention_mask_gates", **r))
        ok &= r["ok"]
    emit(dict(phase="kernels", elapsed_s=time.perf_counter() - t_start))

    # 4. the serving path; counts are zeroed just before each generate
    # call inside serve_7b and read just after it
    launches = {}

    def add(counts):
        for kname, c in counts.items():
            launches[kname] = launches.get(kname, 0) + c

    reset_kernel_launches()
    with watchdog("path", PATH_PHASE_S):
        path, counts = serve_7b(torch, dev)
    add(counts)
    for r in path["runs"]:
        emit(dict(phase="path", **r))
        ok &= r["ok"]
    emit(dict(phase="path", setup_s=path["setup_s"], peak_gb=path["peak_gb"],
              elapsed_s=time.perf_counter() - t_start))
    # 5. parity on the card
    with watchdog("parity", PATH_PHASE_S):
        parity_rows = parity_2layer(torch, dev)
    for r in parity_rows:
        emit(dict(phase="parity", **r))
        ok &= r["ok"]
    emit(dict(phase="parity", elapsed_s=time.perf_counter() - t_start))

    # 6. the continuous-batching path; counts are zeroed just before each
    # run inside serve_cb_7b and read just after it
    with watchdog("cb_path", PATH_PHASE_S):
        cb, counts = serve_cb_7b(torch, dev)
    add(counts)
    for r in cb["runs"] + [cb["single"], cb["width"]]:
        emit(dict(phase="cb_path", **r))
        ok &= r["ok"]
    for r in cb["sampled"]:
        emit(dict(phase="cb_sampled", **r))
        ok &= r["ok"]
    emit(dict(phase="proc", **cb["proc"]))
    ok &= cb["proc"]["ok"]
    for r in cb["spec"]:
        emit(dict(phase="cb_spec", **r))
        ok &= r["ok"]
    for r in cb["tp"]["runs"]:
        emit(dict(phase="tp_path", **r))
        ok &= r["ok"]
    emit(dict(phase="tp_path", peak_gb=cb["tp"]["peak_gb"], seconds=cb["tp"]["seconds"],
              label="tp shards run one after another on one card"))
    emit(dict(phase="cb_path", peak_gb=cb["peak_gb"], busy=cb["busy"],
              elapsed_s=time.perf_counter() - t_start))

    # 7. continuous-batching parity on the card
    with watchdog("cb_parity", PATH_PHASE_S):
        cb_parity_rows = parity_cb_2layer(torch, dev)
    for r in cb_parity_rows:
        emit(dict(phase="cb_parity", **r))
        ok &= r["ok"]
    with watchdog("cb_sampled_parity", PATH_PHASE_S):
        cb_sampled_parity_rows = parity_cb_sampled(torch, dev)
    for r in cb_sampled_parity_rows:
        emit(dict(phase="cb_sampled_parity", **r))
        ok &= r["ok"]
    emit(dict(phase="cb_parity", elapsed_s=time.perf_counter() - t_start))

    # 8. the training path; counts are zeroed just before each
    # configuration's run inside train_path and read just after it
    with watchdog("train_path", PATH_PHASE_S):
        runs, counts = train_path(torch, dev)
    add(counts)
    for r in runs:
        emit(dict(phase="train_path", **r))
        ok &= r["ok"]
    emit(dict(phase="train_path", elapsed_s=time.perf_counter() - t_start))

    # 9. training parity on the card
    with watchdog("train_parity", PATH_PHASE_S):
        train_parity_rows = train_parity(torch, dev)
    for r in train_parity_rows:
        emit(dict(phase="train_parity", **r))
        ok &= r["ok"]
    emit(dict(phase="train_parity", elapsed_s=time.perf_counter() - t_start))

    # 10. the GPT training path (dropout on); counts are zeroed just
    # before the run inside train_path and read just after it
    with watchdog("gpt_train_path", PATH_PHASE_S):
        runs, counts = train_path(torch, dev, GPT_TRAIN_RUNS)
    add(counts)
    for r in runs:
        emit(dict(phase="gpt_train_path", **r))
        ok &= r["ok"]
    emit(dict(phase="gpt_train_path", mask_draw_ms=mask_draw_ms(torch, dev),
              elapsed_s=time.perf_counter() - t_start))

    # 11. GPT training parity on the card, dropout on
    with watchdog("gpt_train_parity", PATH_PHASE_S):
        gpt_train_parity_rows = gpt_train_parity(torch, dev)
    for r in gpt_train_parity_rows:
        emit(dict(phase="gpt_train_parity", **r))
        ok &= r["ok"]
    emit(dict(phase="gpt_train_parity", elapsed_s=time.perf_counter() - t_start))

    # 12. the BERT MLM training path (masked, non-causal attention with
    # dropout); counts are zeroed just before each run inside
    # bert_train_path and read just after it
    with watchdog("bert_train_path", PATH_PHASE_S):
        runs, counts = bert_train_path(torch, dev)
    add(counts)
    for r in runs:
        emit(dict(phase="bert_train_path", **r))
        ok &= r["ok"]
    emit(dict(phase="bert_train_path", elapsed_s=time.perf_counter() - t_start))

    # 13. BERT training parity on the card, dropout on
    with watchdog("bert_train_parity", PATH_PHASE_S):
        bert_train_parity_rows = bert_train_parity(torch, dev)
    for r in bert_train_parity_rows:
        emit(dict(phase="bert_train_parity", **r))
        ok &= r["ok"]
    emit(dict(phase="bert_train_parity", launches=launches,
              elapsed_s=time.perf_counter() - t_start))
    # the f32 builds' launches: each kernel's less its bf16 ones
    for kind in ("fwd", "bwd"):
        launches[f"flash_attention_{kind}_f32"] = (
            launches.get(f"flash_attention_{kind}", 0)
            - launches.get(f"flash_attention_{kind}_tc", 0))
    # every kernel was launched on the main paths
    ok &= all(launches.get(k, 0) > 0 for k in SOURCES)

    if not ok:
        print("chip_smoke: a phase failed (see the lines with \"ok\": false)",
              file=sys.stderr)
        return 1
    kernels = []
    for name, r in main_rows.items():
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=launches.get(name, 0), max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

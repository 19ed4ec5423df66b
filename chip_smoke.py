#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (H100).

Phases, each printing one JSON line; any failure exits non-zero:
  1. device   the card's name and power limit; TF32 off
  2. build    nvcc builds every kernel under paddle_tpu_torch/csrc
  3. kernels  each kernel against its plain PyTorch version at the serving
              path's shapes (bf16), with times, bounds and library times;
              the decode megakernel at 7B width (one layer, a 2-layer whole
              step with the head, a constructed argmax tie; bf16 and int8)
              beside the op chain's time on the same inputs
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
              twice; a single request with exact launch counts; one
              steady-state stretch of fused blocks under torch.profiler
              (op chain and "multi") for the device's busy share
  7. cb_parity  the CB engine on the card (bf16, K=8, kernels; op chain and
              "multi") against the CPU CB engine (f32, plain versions), 2
              layers at 7B width
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

Phase 3 also holds the ragged kernel at tq = 1 against the decode kernel
bit for bit (bf16 and f32, page 64 and page 8), a gate of the paged row.
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
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak

REPLACES = {
    "quantized_matmul": "paddle_tpu/ops/pallas/quantized_matmul.py:53",
    "paged_attention": "paddle_tpu/ops/pallas/paged_attention.py:39",
    "flash_attention_fwd": "paddle_tpu/ops/pallas/flash_attention.py:109",
    "ragged_paged_attention": "paddle_tpu/ops/pallas/paged_attention.py:211",
    "rms_norm": "paddle_tpu/ops/pallas/rms_norm.py:45",
    "flash_attention_bwd": "paddle_tpu/ops/pallas/flash_attention.py:430",
    "decode_megakernel": "paddle_tpu/ops/pallas/decode_megakernel.py:272",
}
SOURCES = {
    "quantized_matmul": "paddle_tpu_torch/csrc/quantized_matmul.cu",
    "paged_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
    "flash_attention_fwd": "paddle_tpu_torch/csrc/flash_attention.cu",
    "ragged_paged_attention": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
    "rms_norm": "paddle_tpu_torch/csrc/rms_norm.cu",
    "flash_attention_bwd": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
    "decode_megakernel": "paddle_tpu_torch/csrc/decode_megakernel.cu",
}



def emit(obj):
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes, flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS_PER_S
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
        paged_attention, paged_attention_reference, ragged_paged_attention)
    rows = []
    # main path shape, then a GQA group and the tiny model's d = 16 (f32)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (("mha", 4, 32, 32, 128, 64, [300, 257, 311, 290], [1, 1, 1, 0], bf16),
             ("gqa rep=4", 4, 32, 8, 128, 64, [300, 1, 129, 64], [1, 1, 1, 1], bf16),
             ("d=16 f32", 3, 4, 4, 16, 16, [37, 0, 100], [1, 1, 1], f32))
    for name, b, h, h_kv, d, p, lens, active, dt in cases:
        q, kp, vp, table, lens_t, act = paged_inputs(torch, dev, b, h, h_kv, d, p,
                                                     lens, active, dt, seed=2)
        got = paged_attention(q, kp, vp, table, lens_t, active=act)
        ref = paged_attention_reference(q, kp, vp, table, lens_t, active=act)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        # outputs are convex mixes of N(0,1) rows: bf16 rounds at ~4e-3;
        # f32 differs only in the order of the sums
        tol = 1e-2 if dt == bf16 else 1e-4
        row = dict(case=name, b=b, h=h, h_kv=h_kv, d=d, p=p, lens=lens, active=active,
                   max_abs_err=err, tol=tol, ok=err <= tol)
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
            # the ragged kernel at tq = 1, q_start = len - 1, against the
            # decode kernel: bit for bit (they share one per-page step)
            tq1 = tq1_identity(torch, dev)
            row["ragged_tq1"] = tq1
            row["ragged_tq1_max_abs_diff"] = max(c["max_abs_diff"] for c in tq1)
            row["ragged_tq1_identical"] = all(c["identical"] for c in tq1)
            row["ok"] = row["ok"] and row["ragged_tq1_identical"]
        rows.append(row)
    return rows


def tq1_identity(torch, dev):
    """B5 at tq = 1 with q_start = len - 1 against B3 on the same inputs:
    bf16 and f32, page 64 and page 8, MHA and a GQA group of 4, ragged
    lengths (one inactive slot, one of length 1)."""
    from paddle_tpu_torch.ops.pallas.paged_attention import (
        paged_attention, ragged_paged_attention)
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
                dec = paged_attention(q, kp, vp, table, ln, active=ac)
                rag = ragged_paged_attention(q[:, None], kp, vp, table, ln, ln - 1,
                                             active=ac)[:, 0]
                torch.cuda.synchronize()
                cases.append(dict(dtype=str(dt), page=p, h=h, h_kv=h_kv,
                                  max_abs_diff=max_err(rag, dec),
                                  identical=bool(torch.equal(rag, dec))))
    return cases


LIBRARY_CALL = ("torch.nn.functional.scaled_dot_product_attention with a boolean mask, "
                "K/V gathered into contiguous form beforehand (the gather is not timed)")


def sdpa_paged_ms(torch, q, kp, vp, table, q_starts, ctx_lens, act):
    """Yardstick: one SDPA call on each slot's pages gathered beforehand
    (GQA heads expanded), masked causally at the ragged offsets."""
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
    return time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                attn_mask=mask))


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
        ragged_paged_attention, ragged_paged_attention_reference)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    # main path shape (8 slots, 128-token chunks at ragged offsets; slot 3
    # ends mid-chunk, slot 7 inactive), then a GQA group, then the tiny
    # model's d = 16 in f32
    main_starts = [0, 128, 384, 640, 0, 256, 512, 0]
    cases = (("main", 8, 128, 32, 32, 128, 64, 16, main_starts,
              [128, 256, 512, 690, 128, 384, 640, 128], [1, 1, 1, 1, 1, 1, 1, 0], bf16),
             ("gqa rep=4", 4, 128, 32, 8, 128, 64, 16, [0, 200, 64, 700],
              [128, 328, 100, 828], [1, 1, 1, 1], bf16),
             ("d=16 f32", 3, 8, 4, 2, 16, 8, 6, [0, 5, 23], [8, 13, 27], [1, 0, 1], f32))
    for name, b, tq, h, h_kv, d, p, mp, starts, ctx, active, dt in cases:
        q, kp, vp, table = ragged_inputs(torch, dev, b, tq, h, h_kv, d, p, mp, dt, seed=4)
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
        act = torch.tensor(active, dtype=torch.int32, device=dev)
        got = ragged_paged_attention(q, kp, vp, table, cl, st, active=act)
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
                   q_starts=starts, ctx_lens=ctx, active=active, max_abs_err=err, tol=tol,
                   inactive_zero=zeros_ok, finite=finite,
                   ok=err <= tol and zeros_ok and finite)
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


def check_flash(torch, dev):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.pallas.flash_attention import (
        flash_attention_fwd, flash_attention_reference)
    rows = []
    for b, s, s_true, h, d, dt in ((4, 320, 300, 32, 128, torch.bfloat16),
                                   (2, 130, 100, 2, 64, torch.float32)):
        g = torch.Generator(device=dev).manual_seed(3)
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        o, lse = flash_attention_fwd(q, k, v, True, scale, s_true=s_true)
        o_ref, lse_ref = flash_attention_reference(q, k, v, True, scale, s_true=s_true)
        torch.cuda.synchronize()
        err = max_err(o, o_ref)
        lse_err = max_err(lse, lse_ref)
        # o: bf16 rounding (or, in f32, the order of the sums); lse is f32
        tol, lse_tol = (1e-2 if dt == torch.bfloat16 else 1e-4), 1e-3
        row = dict(b=b, s=s, s_true=s_true, h=h, d=d, dtype=str(dt), max_abs_err=err, tol=tol,
                   lse_max_abs_err=lse_err, lse_tol=lse_tol,
                   ok=err <= tol and lse_err <= lse_tol)
        if d == 128:
            row["ms"] = time_ms(torch, lambda: flash_attention_fwd(q, k, v, True, scale,
                                                                   s_true=s_true))
            row["plain_ms"] = time_ms(torch, lambda: flash_attention_reference(
                q, k, v, True, scale, s_true=s_true), iters=5)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale))
            pairs = sum(min(r + 1, s_true) for r in range(s))
            n_bytes = 4 * b * s * h * d * 2 + b * h * s * 4
            row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, 4 * b * h * d * pairs)
        rows.append(row)
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
        flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd)
    bf16 = torch.bfloat16
    rows = []
    for b, s, h, d, dt in FLASH_BWD_CASES:
        dt = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(7)
        q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev).to(dt)
                       for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        o, lse = flash_attention_fwd(q, k, v, True, scale)
        got = flash_attention_bwd(q, k, v, o, lse, do, True, scale)
        ref = flash_attention_bwd_reference(q, k, v, o, lse, do, True, scale)
        torch.cuda.synchronize()
        errs = {n: max_err(a, r) for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
        # per gradient, relative to its largest entry: bf16 rounds the
        # output once (2^-8) after f32 sums; f32 differs in sum order only
        rel = 1e-2 if dt == bf16 else 1e-4
        tols = {n: rel * float(r.float().abs().max()) for n, r in zip(("dq", "dk", "dv"), ref)}
        del got, ref
        row = dict(b=b, s=s, h=h, d=d, dtype=str(dt), max_abs_err=max(errs.values()),
                   max_abs_err_by_grad=errs, tol_by_grad=tols,
                   ok=all(errs[n] <= tols[n] for n in errs))
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
                "quantized_matmul": (7 * L + 1) * (1 + n_loop) if wname == "int8" else 0,
                "flash_attention_fwd": L if t_pad >= eng.flash_prefill_min else 0,
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


def drive_cb(torch, eng, prompts, budgets):
    """Submit the stream, step to idle; returns (outputs, wall seconds,
    ms per decode micro-step over the steps that ran decode only)."""
    uids = [eng.add_request(p, n) for p, n in zip(prompts, budgets)]
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
    results, launches, base, busy = [], {}, {}, {}
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
                     and counts["decode_megakernel"] == expect_mk
                     and dec > 0
                     and counts["quantized_matmul"] == expect_qmm
                     and (counts["quantized_matmul"] > 0) == bool(quant)
                     and counts["ragged_paged_attention"] % L == 0
                     and ((counts["ragged_paged_attention"] > 0) if K > 1
                          else counts["ragged_paged_attention"] == 0))
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
    # one request on a fresh op-chain engine: three prefill-only blocks (300
    # tokens in chunks of 128), then two decode blocks of 8, the second chained
    eng = ContinuousBatchingEngine(model, decode_block=8, megakernel=False, **geom)
    ids = np.random.RandomState(1).randint(0, V, 300).astype(np.int64)
    reset_kernel_launches()
    out = eng.generate_many([ids], max_new_tokens=17)[0]
    counts = kernel_launches()
    h = eng.health()
    expect = dict.fromkeys(counts, 0)
    expect.update({"paged_attention": 2 * 8 * L, "ragged_paged_attention": 3 * L})
    single = dict(run="single t0=300 budget=17 K=8", launches=counts,
                  expected_launches=expect, fused_blocks=h["fused_blocks"],
                  chained_blocks=h["chained_blocks"], out_len=int(out.size),
                  ok=counts == expect and out.size == 317 and h["chained_blocks"] == 1
                  and h["pages_free"] + h["prefix_pages"] == h["pages_total"])
    for kname, c in counts.items():
        launches[kname] = launches.get(kname, 0) + c
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del eng, model
    torch.cuda.empty_cache()
    return dict(runs=results, single=single, peak_gb=peak_gb, busy=busy), launches


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
    for mk in (False, "multi"):
        gpu = ContinuousBatchingEngine(model, device=dev, weight_dtype="bfloat16",
                                       megakernel=mk, **kw)
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
        rows.append(dict(megakernel=gpu.health()["megakernel"], requests=len(prompts),
                         prompt_lens=[int(p.size) for p in prompts], tol=tol,
                         greedy_compared=compared, greedy_equal=equal,
                         ok=compared > 0 and equal == compared))
        del gpu
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 8
TRAIN_RUNS = (
    # config, warmup, timed steps, exact kernel launches per step
    # llama350m, save_attn: 16 forward attentions (the recompute replays
    # their o and lse), 16 backward, norms 2 x 16 + 1 forward and 2 x 16
    # again in the recompute
    ("llama350m", 3, 10, {"flash_attention_fwd": 16, "flash_attention_bwd": 16,
                          "rms_norm": 65}),
    # llama1p3b, full: every layer's forward runs again in backward
    ("llama1p3b", 2, 5, {"flash_attention_fwd": 48, "flash_attention_bwd": 24,
                         "rms_norm": 97}),
)


def train_path(torch, dev):
    from paddle_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from paddle_tpu_torch.train_llama import run_config
    results, launches = [], {}
    for name, warmup, steps, per_step in TRAIN_RUNS:
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
def train_parity(torch, dev):
    """The trainer on the card against the trainer on the CPU (f32, plain
    versions) from one state: 2 layers at the 350m width and vocab, bs 4,
    seq 256, 3 steps, recompute save_attn, lr 1e-4."""
    import numpy as np
    from paddle_tpu_torch.models import SpmdTrainer
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=32000, hidden_size=1024, intermediate_size=2816,
                      num_hidden_layers=2, num_attention_heads=16,
                      max_position_embeddings=1024)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, cfg.vocab_size, (4, 256)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    kw = dict(lr=1e-4, recompute=True, recompute_policy="save_attn")

    def run(device, **extra):
        model = LlamaForCausalLM(cfg, device=device, seed=5)
        model.load_state_dict(cpu_model.state_dict())
        tr = SpmdTrainer(model, **kw, **extra)
        st = tr.init_state()
        losses = []
        for _ in range(3):
            st, loss = tr.step(st, ids, labels)
            losses.append(float(loss))
        return losses, {n: t.float().cpu() for n, t in st["params"].items()}

    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=5)
    ref_losses, ref_params = run("cpu")
    rows = []
    # f32 on the card, TF32 off: the same math in another summation order;
    # bf16 on the card: bf16 params, activations and products against f32
    for name, extra, tol in (("f32", dict(param_dtype="float32"), 1e-3),
                             ("bf16", dict(param_dtype="bfloat16"), 2e-2)):
        losses, params = run(dev, **extra)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        pdiff = max(float((params[n] - ref_params[n]).abs().max()) for n in ref_params)
        rows.append(dict(card=name, cpu="f32", losses=losses, cpu_losses=ref_losses,
                         loss_max_rel_diff=rel, tol=tol, param_max_abs_diff=pdiff,
                         ok=rel <= tol and all(math.isfinite(x) for x in losses)))
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
    emit(dict(phase="build", seconds=build_s, path=_build.build_info()["path"],
              ptxas=ptxas_summary(_build.build_log() or "")))

    # 3. kernels
    main_rows = {}
    checks = (("quantized_matmul", check_quantized_matmul),
              ("paged_attention", check_paged_attention),
              ("flash_attention_fwd", check_flash),
              ("ragged_paged_attention", check_ragged),
              ("rms_norm", check_rms), ("flash_attention_bwd", check_flash_bwd),
              ("decode_megakernel", check_megakernel))
    for name, check in checks:
        rows = check(torch, dev)
        for r in rows:
            emit(dict(phase="kernels", kernel=name, **r))
            ok &= r["ok"]
        # the row at the main path's shape (the first with a time;
        # quantized_matmul: the decode GEMV of gate/up)
        main_rows[name] = next(r for r in rows if "ms" in r and (
            name != "quantized_matmul" or (r["m"] == 4 and r["n"] == 11008)))
    emit(dict(phase="kernels", elapsed_s=time.perf_counter() - t_start))

    # 4. the serving path; counts are zeroed just before each generate
    # call inside serve_7b and read just after it
    launches = {}

    def add(counts):
        for kname, c in counts.items():
            launches[kname] = launches.get(kname, 0) + c

    reset_kernel_launches()
    path, counts = serve_7b(torch, dev)
    add(counts)
    for r in path["runs"]:
        emit(dict(phase="path", **r))
        ok &= r["ok"]
    emit(dict(phase="path", setup_s=path["setup_s"], peak_gb=path["peak_gb"],
              elapsed_s=time.perf_counter() - t_start))
    # 5. parity on the card
    for r in parity_2layer(torch, dev):
        emit(dict(phase="parity", **r))
        ok &= r["ok"]
    emit(dict(phase="parity", elapsed_s=time.perf_counter() - t_start))

    # 6. the continuous-batching path; counts are zeroed just before each
    # run inside serve_cb_7b and read just after it
    cb, counts = serve_cb_7b(torch, dev)
    add(counts)
    for r in cb["runs"] + [cb["single"]]:
        emit(dict(phase="cb_path", **r))
        ok &= r["ok"]
    emit(dict(phase="cb_path", peak_gb=cb["peak_gb"], busy=cb["busy"],
              elapsed_s=time.perf_counter() - t_start))

    # 7. continuous-batching parity on the card
    for r in parity_cb_2layer(torch, dev):
        emit(dict(phase="cb_parity", **r))
        ok &= r["ok"]
    emit(dict(phase="cb_parity", elapsed_s=time.perf_counter() - t_start))

    # 8. the training path; counts are zeroed just before each
    # configuration's run inside train_path and read just after it
    runs, counts = train_path(torch, dev)
    add(counts)
    for r in runs:
        emit(dict(phase="train_path", **r))
        ok &= r["ok"]
    emit(dict(phase="train_path", elapsed_s=time.perf_counter() - t_start))

    # 9. training parity on the card
    for r in train_parity(torch, dev):
        emit(dict(phase="train_parity", **r))
        ok &= r["ok"]
    emit(dict(phase="train_parity", launches=launches,
              elapsed_s=time.perf_counter() - t_start))
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

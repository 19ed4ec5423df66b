"""KV-page handoff of paddle_tpu_torch against the JAX package.

Replays tests/test_kv_handoff.py's TestAllocatorTransfer and
TestEngineHandoff against the port's PageAllocator and
ContinuousBatchingEngine(device="cpu") on a micro LLaMA (1 layer, hidden
32, ffn 64, 4 heads over 2 kv heads; f32; weights carried over by name),
and adds the cross-package and cross-feature cases.

Exact (bits): every greedy id — a continuation after a handoff (first
token, mid-decode, over the store transport on a torch.distributed
HashStore, over the device transport, tp = 2 into tp = 1, an adapter
request migrating with its adapter, a JAX-exported payload imported by the
port) equals the JAX engine's uninterrupted run. The CRCs and
`StoreKVTransport._pack`'s manifest and blob of the same f32 and bf16 page
bytes (bf16 as the port's uint16 view, ml_dtypes' bfloat16 in the
reference) equal the reference's.
"""
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import ml_dtypes
import paddle_tpu as paddle
from paddle_tpu.inference import handoff as jho
from paddle_tpu.inference.scheduler import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import failsafe
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference import handoff as tho
from paddle_tpu_torch.inference.adapters import make_lora_adapter
from paddle_tpu_torch.inference.handoff import KVHandoffError, StoreKVTransport
from paddle_tpu_torch.inference.scheduler import (ContinuousBatchingEngine,
                                                  EngineBusyError)
from paddle_tpu_torch.inference.serving import EngineFullError, PageAllocator
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

ENGINE_KW = dict(max_len=64, page_size=8, max_batch=2, prefill_chunk=8)
MICRO = dict(num_hidden_layers=1, hidden_size=32, intermediate_size=64,
             num_attention_heads=4, num_key_value_heads=2)
_PAIR = {}


@pytest.fixture(autouse=True)
def _clean_faults():
    failsafe.reset()
    yield
    failsafe.reset()


def _pair():
    if not _PAIR:
        paddle.seed(3)
        jm = JaxLlama(JaxConfig.tiny(**MICRO))
        tm = LlamaForCausalLM(LlamaConfig.tiny(**MICRO), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _PAIR["m"] = (jm, tm)
    return _PAIR["m"]


def _mk(**over):
    return ContinuousBatchingEngine(_pair()[1], device="cpu",
                                    **dict(ENGINE_KW, **over))


V = LlamaConfig.tiny(**MICRO).vocab_size
P1 = np.arange(1, 12) % (V - 1) + 1
P2 = np.arange(2, 10) % (V - 1) + 1
P3 = np.arange(3, 14) % (V - 1) + 1


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX engine's uninterrupted runs (one engine, the prompts in
    turn) and one payload it exported at first token."""
    jm, _ = _pair()
    eng = JaxEngine(jm, **ENGINE_KW)
    out = {}
    for name, p, n in (("p1", P1, 12), ("p2", P2, 10), ("p3", P3, 10)):
        u = eng.add_request(p, max_new_tokens=n)
        eng.drain()
        out[name] = eng.result(u)
    src = JaxEngine(jm, **ENGINE_KW)
    u = src.add_request(P1, max_new_tokens=12)
    while src.status(u) != "decode":
        src.step()
    out["payload"] = src.export_kv_pages(u)
    return out


def _prefill_to_first_token(eng, prompt, mnt=12, **kw):
    uid = eng.add_request(prompt, max_new_tokens=mnt, **kw)
    while eng.status(uid) != "decode":
        eng.step()
    return uid


def _no_leak(eng):
    held = len(eng._prefix) if eng._prefix is not None else 0
    assert eng.allocator.available == eng.allocator.n_pages - held, (
        eng.allocator.available, eng.allocator.n_pages, held)


# -- allocator tickets ------------------------------------------------------------
class TestAllocatorTransfer:
    def test_export_commit_moves_ownership(self):
        al = PageAllocator(8)
        pages = [al.alloc() for _ in range(3)]
        tok = al.export_begin(pages)
        assert al.available == 5
        al.export_commit(tok)
        assert al.available == 8
        with pytest.raises(RuntimeError, match="unknown/closed"):
            al.export_commit(tok)

    def test_export_abort_leaves_pages(self):
        al = PageAllocator(8)
        pages = [al.alloc() for _ in range(2)]
        tok = al.export_begin(pages)
        al.export_abort(tok)
        assert al.available == 6
        al.free(pages)
        assert al.available == 8

    def test_export_of_free_page_raises(self):
        al = PageAllocator(4)
        p = al.alloc()
        al.free([p])
        with pytest.raises(RuntimeError, match="not a live page"):
            al.export_begin([p])

    def test_shared_page_export_keeps_other_holders(self):
        al = PageAllocator(4)
        p = al.alloc()
        al.share(p)
        tok = al.export_begin([p])
        al.export_commit(tok)
        assert al.refcount(p) == 1
        assert al.available == 3

    def test_double_import_raises(self):
        src, dst = PageAllocator(8), PageAllocator(8)
        tok = src.export_begin([src.alloc(), src.alloc()])
        got = dst.import_begin(tok, 3)
        assert len(got) == 3 and dst.available == 5
        dst.import_commit(tok)
        with pytest.raises(RuntimeError, match="double import"):
            dst.import_begin(tok, 3)
        tok2 = src.export_begin([src.alloc()])
        dst.import_begin(tok2, 1)
        with pytest.raises(RuntimeError, match="double import"):
            dst.import_begin(tok2, 1)

    def test_import_abort_rolls_back_and_allows_retry(self):
        dst = PageAllocator(8)
        dst.import_begin("ticket-xyz", 4)
        assert dst.available == 4
        dst.import_abort("ticket-xyz")
        assert dst.available == 8
        assert len(dst.import_begin("ticket-xyz", 2)) == 2
        dst.import_commit("ticket-xyz")

    def test_import_overflow_claims_nothing(self):
        dst = PageAllocator(4)
        keep = [dst.alloc() for _ in range(3)]
        with pytest.raises(EngineFullError):
            dst.import_begin("t", 2)
        assert dst.available == 1
        dst.import_begin("t", 1)
        dst.import_commit("t")
        dst.free(keep)


# -- the wire format against the reference ------------------------------------------
def _pages(dtype):
    rng = np.random.RandomState(8)
    return [rng.randn(2, 8, 2, 8).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("kv", ["float32", "bfloat16"])
def test_crc_and_packed_bytes_equal_reference(kv):
    """Exact: the same page bytes give the reference's page and metadata
    CRCs and its packed manifest and blob, byte for byte; the unpacked
    port payload holds the same bytes."""
    pages = _pages(kv)
    if kv == "bfloat16":
        ref_blobs = [p.astype(ml_dtypes.bfloat16) for p in pages]
        port_blobs = [tho.to_host(torch.from_numpy(p).to(torch.bfloat16))
                      for p in pages]
        assert all(a.dtype == np.uint16 for a in port_blobs)
    else:
        ref_blobs = port_blobs = pages

    def payload(blobs):
        return {"token": "tok-1", "lens": 13,
                "spec": {"uid": 4, "state": "decode",
                         "prompt": np.arange(13, dtype=np.int64),
                         "generated": 2, "max_new_tokens": 6,
                         "eos_token_id": None, "tenant": "default",
                         "priority": 0, "ttl_steps": None, "deadline": None,
                         "deadline_remaining_ms": 812.5},
                "geometry": {"page_size": 8, "nh_kv": 2, "hd": 8,
                             "layers": 2, "kv_dtype": kv},
                "k": list(blobs[:2]), "v": list(blobs[2:])}

    ref = jho.checksum_payload(payload(ref_blobs))
    got = tho.checksum_payload(payload(port_blobs))
    assert got["crc"] == ref["crc"]
    assert tho.StoreKVTransport._pack(got) == jho.StoreKVTransport._pack(ref)
    back = tho.verify_payload(tho.StoreKVTransport._unpack(
        *tho.StoreKVTransport._pack(got)))
    for a, b in zip(back["k"] + back["v"], port_blobs):
        assert a.tobytes() == b.tobytes()
    if kv == "bfloat16":
        t = tho.from_host(back["k"][0], torch.bfloat16)
        assert t.dtype == torch.bfloat16
        assert t.float().numpy().tobytes() == \
            np.asarray(ref_blobs[0], np.float32).tobytes()


# -- engine handoff -----------------------------------------------------------------
class TestEngineHandoff:
    def test_continuation_byte_identical(self, jax_ref):
        A, B = _mk(), _mk()
        ua = _prefill_to_first_token(A, P1)
        payload = A.export_kv_pages(ua)
        ub = B.import_kv_pages(payload)
        A.release_handoff(ua)
        assert A.status(ua) == "migrated"
        assert A.handoffs_out == 1 and B.handoffs_in == 1
        assert A.health()["handoffs_out"] == 1
        B.drain()
        np.testing.assert_array_equal(B.result(ub), jax_ref["p1"])
        _no_leak(A)
        _no_leak(B)

    def test_mid_decode_handoff(self, jax_ref):
        A, B = _mk(), _mk()
        ua = _prefill_to_first_token(A, P2, mnt=10)
        for _ in range(3):
            A.step()
        assert A.status(ua) == "decode"
        ub = B.import_kv_pages(A.export_kv_pages(ua))
        A.release_handoff(ua)
        B.drain()
        np.testing.assert_array_equal(B.result(ub), jax_ref["p2"])

    @pytest.mark.parametrize("K", [2, 4])
    def test_fused_source_settles_its_chained_block(self, jax_ref, K):
        """A fused source with a chained block in flight settles it before
        it exports (the export reads current host state)."""
        A, B = _mk(decode_block=K), _mk(decode_block=K)
        ua = _prefill_to_first_token(A, P3, mnt=10)
        A.step()
        assert A._pending is not None       # a chained block in flight
        ub = B.import_kv_pages(A.export_kv_pages(ua))
        assert A._pending is None
        A.release_handoff(ua)
        B.drain()
        np.testing.assert_array_equal(B.result(ub), jax_ref["p3"])

    def test_corrupt_payload_rejected_and_rolled_back(self):
        A, B = _mk(), _mk()
        ua = _prefill_to_first_token(A, P1)
        payload = A.export_kv_pages(ua)
        payload["v"][0] = np.array(payload["v"][0])
        payload["v"][0].flat[3] += 1.0
        free_before = B.allocator.available
        with pytest.raises(KVHandoffError, match="CRC mismatch"):
            B.import_kv_pages(payload)
        assert B.allocator.available == free_before
        assert len(B) == 0
        A.abort_handoff(ua)
        A.drain()
        assert A.status(ua) == "done"

    def test_import_without_free_slot_is_backpressure(self):
        A, B = _mk(), _mk(max_batch=1)
        _prefill_to_first_token(B, (P2 + 1) % V, mnt=20)
        ua = _prefill_to_first_token(A, P2)
        payload = A.export_kv_pages(ua)
        with pytest.raises(EngineBusyError):
            B.import_kv_pages(payload)
        A.abort_handoff(ua)
        A.drain()
        assert A.status(ua) == "done"

    def test_geometry_mismatch_rejected(self):
        A, B = _mk(), _mk(page_size=16)
        ua = _prefill_to_first_token(A, P2)
        payload = A.export_kv_pages(ua)
        with pytest.raises(KVHandoffError, match="geometry"):
            B.import_kv_pages(payload)
        A.abort_handoff(ua)

    def test_deadline_ships_relative_and_rebases(self):
        A, B = _mk(), _mk()
        ua = _prefill_to_first_token(A, P2, deadline_ms=60000)
        payload = A.export_kv_pages(ua)
        assert payload["spec"]["deadline"] is None
        assert 0 < payload["spec"]["deadline_remaining_ms"] <= 60000
        ub = B.import_kv_pages(payload)
        A.release_handoff(ua)
        left = B._requests[ub].deadline - time.monotonic()
        assert 0 < left <= 60.0
        B.drain()
        assert B.status(ub) == "done"

    def test_store_transport_roundtrip(self, jax_ref):
        """Exact, over a torch.distributed.HashStore with forced chunking."""
        tx = StoreKVTransport(dist.HashStore(), chunk_bytes=1024)
        A, B = _mk(), _mk()
        ua = _prefill_to_first_token(A, P3, mnt=10)
        key = tx.send(A.export_kv_pages(ua, transport="store"))
        payload = tx.recv(key)
        assert payload["transport"] == "store"
        ub = B.import_kv_pages(payload)
        A.release_handoff(ua)
        tx.delete(key)
        assert not tx.store.check([key + "/manifest"])
        B.drain()
        np.testing.assert_array_equal(B.result(ub), jax_ref["p3"])

    def test_device_transport_and_its_fault_point(self, jax_ref):
        A, B = _mk(), _mk()
        ua = _prefill_to_first_token(A, P1)
        with failsafe.inject("transport.device", nth=1):
            with pytest.raises(failsafe.InjectedFault):
                A.export_kv_pages(ua, device=True)
        payload = A.export_kv_pages(ua, device=True)
        assert payload["transport"] == "device"
        assert torch.is_tensor(payload["k"][0])
        assert payload["crc"]["k"] is None
        with pytest.raises(KVHandoffError, match="device"):
            StoreKVTransport._pack(payload)
        ub = B.import_kv_pages(payload)
        A.release_handoff(ua)
        B.drain()
        np.testing.assert_array_equal(B.result(ub), jax_ref["p1"])

    def test_import_fault_point_claims_nothing(self):
        A, B = _mk(), _mk()
        ua = _prefill_to_first_token(A, P1)
        payload = A.export_kv_pages(ua)
        free = B.allocator.available
        with failsafe.inject("kv.import", nth=1):
            with pytest.raises(failsafe.InjectedFault):
                B.import_kv_pages(payload)
        assert B.allocator.available == free
        B.import_kv_pages(payload)          # the retry lands
        A.release_handoff(ua)
        with pytest.raises(RuntimeError, match="double import"):
            B.import_kv_pages(payload)

    def test_tp2_export_imports_into_tp1(self, jax_ref):
        """Exact: a tp = 2 engine's payload joins the shards' kv heads into
        the full page image; a tp = 1 engine continues it."""
        A, B = _mk(tp=2), _mk()
        ua = _prefill_to_first_token(A, P1)
        payload = A.export_kv_pages(ua)
        assert payload["k"][0].shape[2] == 2          # both kv heads
        ub = B.import_kv_pages(payload)
        A.release_handoff(ua)
        B.drain()
        np.testing.assert_array_equal(B.result(ub), jax_ref["p1"])
        C = _mk(tp=2)                                 # and back to tp = 2
        uc = _prefill_to_first_token(C, P2, mnt=10)
        D = _mk(tp=2)
        ud = D.import_kv_pages(C.export_kv_pages(uc))
        C.release_handoff(uc)
        D.drain()
        np.testing.assert_array_equal(D.result(ud), jax_ref["p2"])

    def test_jax_payload_imports_into_port(self, jax_ref):
        """Exact: a payload the JAX engine exported at first token (numpy
        blobs, its CRCs) is seated by the port and continues with the JAX
        engine's uninterrupted ids."""
        B = _mk()
        ub = B.import_kv_pages(jax_ref["payload"])
        B.drain()
        np.testing.assert_array_equal(B.result(ub), jax_ref["p1"])

    def test_adapter_request_migrates_with_its_adapter(self):
        """Exact: the adapter name rides the spec and the importer resolves
        it in its own pool; the continuation equals the unmigrated run."""
        cfg = LlamaConfig.tiny(**MICRO)
        ad = make_lora_adapter(cfg, rank=4, seed=1)
        ref = _mk(adapters={"rank": 4})
        ref.load_adapter("a1", ad)
        u = ref.add_request(P1, 12, adapter="a1")
        ref.drain()
        A, B = _mk(adapters={"rank": 4}), _mk(adapters={"rank": 4})
        A.load_adapter("a1", ad)
        ua = _prefill_to_first_token(A, P1, adapter="a1")
        payload = A.export_kv_pages(ua)
        assert payload["spec"]["adapter"] == "a1"
        with pytest.raises(KeyError):
            B.import_kv_pages(payload)      # B has no such adapter yet
        B.load_adapter("a1", ad)
        ub = B.import_kv_pages(payload)
        A.release_handoff(ua)
        assert A._apool.active("a1") == 0 and B._apool.active("a1") == 1
        B.drain()
        np.testing.assert_array_equal(B.result(ub), ref.result(u))
        assert B._apool.active("a1") == 0

    def test_export_inflight_and_submit_resume(self, jax_ref):
        """Exact: the spec-requeue path — a request exported mid-decode
        re-prefills its folded prompt on another engine and finishes with
        the uninterrupted ids."""
        A, B = _mk(), _mk()
        ua = _prefill_to_first_token(A, P1)
        A.step()
        uq = A.add_request(P2, 10)
        specs = A.export_inflight()
        assert [s["uid"] for s in specs] == [ua, uq]
        ub = [B.submit_resume(s) for s in specs]
        B.drain()
        np.testing.assert_array_equal(B.result(ub[0]), jax_ref["p1"])
        np.testing.assert_array_equal(B.result(ub[1]), jax_ref["p2"])

    def test_kv_export_fault_and_state_checks(self):
        A = _mk()
        uq = A.add_request(P1, 12)
        with pytest.raises(ValueError, match="decode-state"):
            A.export_kv_pages(uq)           # still queued
        ua = _prefill_to_first_token(A, P2)
        with failsafe.inject("kv.export", nth=1):
            with pytest.raises(failsafe.InjectedFault):
                A.export_kv_pages(ua)
        assert ua not in A._handoffs_out
        with pytest.raises(ValueError, match="no pending export"):
            A.release_handoff(ua)
        A.drain()
        _no_leak(A)


def test_telemetry_legs_of_handoff_and_resume():
    """The handoff legs of the telemetry plane: the source's trace pairs
    "kv_export" with "migrated" (handoff_ms), the importer's holds
    "import_seat" with the transport label, and a resumed spec's trace a
    "resume" marker (so no second TTFT is observed)."""
    from paddle_tpu_torch.inference.telemetry import Telemetry
    A = _mk(telemetry=Telemetry(capture_faults=False))
    B = _mk(telemetry=Telemetry(capture_faults=False))
    ua = _prefill_to_first_token(A, P1)
    ub = B.import_kv_pages(A.export_kv_pages(ua, transport="store"))
    A.release_handoff(ua)
    names = [n for _, n, _ in A.telemetry.trace("engine", ua).events]
    assert names.index("kv_export") < names.index("migrated")
    assert A.telemetry.registry.hist["handoff_ms"].count == 1
    seat = [a for _, n, a in B.telemetry.trace("engine", ub).events
            if n == "import_seat"]
    assert seat and seat[0]["transport"] == "store"
    C = _mk(telemetry=Telemetry(capture_faults=False))
    spec = B.export_request(ub)
    uc = C.submit_resume(spec)
    assert "resume" in [n for _, n, _ in C.telemetry.trace("engine", uc).events]
    B.drain()
    C.drain()
    np.testing.assert_array_equal(B.result(ub), C.result(uc))

"""Atomic CRC checkpoints and engine weight snapshots of paddle_tpu_torch
against the JAX package.

Replays tests/test_fault_injection.py::TestAtomicCheckpoint and
TestAsyncAndPreemption against the port's `distributed/checkpoint.py`
(faults armed in the port's own registry), and adds the cross-package
cases:

  - the same tree saved by either package gives the same leaf files byte
    for byte and the same manifest (CRC list and PyTreeDef string), and
    each package loads the other's save; a bf16 leaf is written as the
    reference writes a bfloat16 array (descr '<V2')
  - a weight snapshot saved by the JAX LLMEngine loads through the port's
    load_weights_snapshot, and the reverse, with equal CRC manifests, and
    after each package's install_weights the ids served equal the other's
    (micro LLaMA, f32; weights carried over by name; the port on the CPU)
  - a flipped byte raises CheckpointCorruptError before anything installs
  - install_weights rebinds: two engines built from one model keep serving
    their own weights after one of them flips

Exact throughout (bytes, CRCs, ids).
"""
import json
import os

import numpy as np
import pytest
import torch

import ml_dtypes
import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import failsafe
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.failsafe import InjectedFault, inject
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

MICRO = dict(num_hidden_layers=1, hidden_size=32, intermediate_size=64,
             num_attention_heads=2)
ENGINE_KW = dict(max_len=64, page_size=8, max_batch=2, prefill_chunk=8)
_MODELS = {}


@pytest.fixture(autouse=True)
def _clean_faults():
    failsafe.reset()
    yield
    failsafe.reset()


def _tree(seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(4, 3).astype(np.float32) * scale,
            "b": rng.randn(3).astype(np.float32) * scale,
            "step_count": np.int64(seed)}


# -- the atomic layer (reference TestAtomicCheckpoint) ------------------------------
class TestAtomicCheckpoint:
    def test_save_load_roundtrip_with_checksums(self, tmp_path):
        st = _tree(1)
        ckpt.save_state(st, str(tmp_path / "ck"), step=7)
        got, index = ckpt.load_state(str(tmp_path / "ck"), like=st)
        assert index["step"] == 7 and len(index["checksums"]) == 3
        np.testing.assert_array_equal(got["w"], st["w"])
        assert not any(".tmp-" in n for n in os.listdir(tmp_path))

    def test_commit_crash_leaves_previous_intact(self, tmp_path):
        root = str(tmp_path / "run")
        ckpt.save_checkpoint(_tree(1), root, step=1)
        with inject("ckpt.commit", nth=1):
            with pytest.raises(InjectedFault):
                ckpt.save_checkpoint(_tree(2), root, step=2)
        assert ckpt.available_steps(root) == [1]
        got, index = ckpt.load_latest(root, like=_tree(0))
        assert index["step"] == 1
        np.testing.assert_array_equal(got["w"], _tree(1)["w"])
        assert not any(".tmp-" in n for n in os.listdir(root))

    def test_hard_crash_torn_tempdir_is_skipped(self, tmp_path):
        root = tmp_path / "run"
        ckpt.save_checkpoint(_tree(1), str(root), step=1)
        torn = root / "step_00000002.tmp-9999-deadbeef"
        torn.mkdir()
        (torn / "leaf_0.npy").write_bytes(b"garbage")
        assert ckpt.available_steps(str(root)) == [1]
        _, index = ckpt.load_latest(str(root), like=_tree(0))
        assert index["step"] == 1

    def test_crash_mid_swap_recovers_from_old_survivor(self, tmp_path):
        root = str(tmp_path / "run")
        ckpt.save_checkpoint(_tree(1), root, step=1)
        path = ckpt.step_dir(root, 1)
        os.rename(path, path + ".old-deadbeef")
        assert ckpt.available_steps(root) == [1]
        got, index = ckpt.load_latest(root, like=_tree(0))
        assert index["step"] == 1
        np.testing.assert_array_equal(got["w"], _tree(1)["w"])

    def test_corrupt_leaf_detected_and_skipped(self, tmp_path):
        root = str(tmp_path / "run")
        ckpt.save_checkpoint(_tree(1), root, step=1)
        ckpt.save_checkpoint(_tree(2), root, step=2)
        leaf = os.path.join(ckpt.step_dir(root, 2), "leaf_0.npy")
        raw = bytearray(open(leaf, "rb").read())
        raw[-1] ^= 0xFF
        open(leaf, "wb").write(bytes(raw))
        with pytest.raises(ckpt.CheckpointCorruptError,
                           match="checksum mismatch"):
            ckpt.load_state(ckpt.step_dir(root, 2))
        got, index = ckpt.load_latest(root, like=_tree(0))
        assert index["step"] == 1
        np.testing.assert_array_equal(got["w"], _tree(1)["w"])

    def test_missing_leaf_is_torn(self, tmp_path):
        path = str(tmp_path / "ck")
        ckpt.save_state(_tree(1), path, step=1)
        os.remove(os.path.join(path, "leaf_1.npy"))
        with pytest.raises(ckpt.CheckpointCorruptError, match="torn"):
            ckpt.load_state(path)

    def test_write_leaf_fault_cleans_temp(self, tmp_path):
        root = str(tmp_path / "run")
        with inject("ckpt.write_leaf", nth=2):
            with pytest.raises(InjectedFault, match="leaf 1"):
                ckpt.save_checkpoint(_tree(1), root, step=1)
        assert ckpt.available_steps(root) == []
        assert not any(".tmp-" in n for n in os.listdir(root))
        with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
            ckpt.load_latest(root)

    def test_resave_same_path_stays_atomic(self, tmp_path):
        path = str(tmp_path / "ck")
        ckpt.save_state(_tree(1), path, step=1)
        ckpt.save_state(_tree(2), path, step=2)
        got, index = ckpt.load_state(path, like=_tree(0))
        assert index["step"] == 2
        np.testing.assert_array_equal(got["w"], _tree(2)["w"])
        assert not any(".old-" in n for n in os.listdir(tmp_path))

    def test_legacy_index_layout_still_loads(self, tmp_path):
        path = tmp_path / "legacy"
        path.mkdir()
        st = _tree(3)
        leaves = ckpt.tree_leaves(st)
        for i, leaf in enumerate(leaves):
            np.save(str(path / f"leaf_{i}.npy"), np.asarray(leaf))
        (path / "index.json").write_text(json.dumps(
            {"n_leaves": len(leaves), "step": 9,
             "treedef": str(ckpt.tree_structure(st))}))
        got, index = ckpt.load_state(str(path), like=st)
        assert index["step"] == 9
        np.testing.assert_array_equal(got["w"], st["w"])


class TestAsyncAndPreemption:
    def test_async_writer_error_propagates(self, tmp_path):
        with inject("ckpt.write_leaf", nth=1):
            ckpt.save_state_async(_tree(1), str(tmp_path / "ck"), step=1)
            with pytest.raises(InjectedFault):
                ckpt.wait_until_finished()
        ckpt.wait_until_finished()

    def test_preemption_flushes_async_save(self, tmp_path):
        root = str(tmp_path / "run")
        final = []
        ckpt.install_preemption_hook(
            callback=lambda: final.append(
                ckpt.save_checkpoint(_tree(5), root, step=5)))
        try:
            ckpt.save_checkpoint(_tree(4), root, step=4, async_=True)
            ckpt.flush_on_preemption()
            assert ckpt.available_steps(root) == [4, 5] and final
        finally:
            ckpt.install_preemption_hook(callback=None)

    def test_model_and_optimizer_pair_is_not_ported(self, tmp_path):
        for fn, args in ((ckpt.save_model_and_optimizer, (None, None, "p")),
                         (ckpt.load_model_and_optimizer, (None, None, "p"))):
            with pytest.raises(NotImplementedError, match="A9.1"):
                fn(*args)


# -- the file format across packages -------------------------------------------------
def _nested(seed):
    rng = np.random.RandomState(seed)
    return {"emb": rng.randn(5, 4).astype(np.float32),
            "layers": [{"wq": (rng.randint(-127, 128, (4, 3)).astype(np.int8),
                               rng.rand(3).astype(np.float32)),
                        "ln": rng.randn(4).astype(np.float32)}] * 2,
            "n": None, "step": np.int64(seed)}


def _files(path):
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path)) if n.endswith(".npy")}


class TestFormatAcrossPackages:
    def test_same_tree_same_files_and_manifest(self, tmp_path):
        st = _nested(1)
        jckpt.save_state(st, str(tmp_path / "j"), step=3)
        ckpt.save_state(st, str(tmp_path / "t"), step=3)
        assert _files(tmp_path / "j") == _files(tmp_path / "t")
        mj, mt = (json.load(open(tmp_path / d / "manifest.json"))
                  for d in ("j", "t"))
        assert mj == mt            # CRC list, leaf count, step, PyTreeDef

    def test_each_package_loads_the_other(self, tmp_path):
        st = _nested(2)
        jckpt.save_state(st, str(tmp_path / "j"), step=1)
        ckpt.save_state(st, str(tmp_path / "t"), step=1)
        got, _ = ckpt.load_state(str(tmp_path / "j"), like=st)
        back, _ = jckpt.load_state(str(tmp_path / "t"), like=st)
        for a, b in ((got, st), (back, st)):
            np.testing.assert_array_equal(a["layers"][1]["wq"][0],
                                          b["layers"][1]["wq"][0])
            np.testing.assert_array_equal(a["emb"], b["emb"])

    def test_bf16_leaf_is_the_reference_bfloat16_file(self, tmp_path):
        x = np.random.RandomState(4).randn(6, 5).astype(np.float32)
        jckpt.save_state({"w": x.astype(ml_dtypes.bfloat16)},
                         str(tmp_path / "j"))
        t = torch.from_numpy(x).to(torch.bfloat16)
        ckpt.save_state({"w": t}, str(tmp_path / "t"))
        assert _files(tmp_path / "j") == _files(tmp_path / "t")
        got, _ = ckpt.load_state(str(tmp_path / "j"), like={"w": t})
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"], t)


# -- engine weight snapshots -----------------------------------------------------------
def _models(seed):
    if seed not in _MODELS:
        paddle.seed(seed)
        jm = JaxLlama(JaxConfig.tiny(**MICRO))
        tm = LlamaForCausalLM(LlamaConfig.tiny(**MICRO), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _MODELS[seed] = (jm, tm)
    return _MODELS[seed]


def _stream():
    rng = np.random.RandomState(9)
    V = LlamaConfig.tiny(**MICRO).vocab_size
    return [rng.randint(0, V, (int(t),)).astype(np.int64)
            for t in (5, 11, 8)], [6, 4, 7]


def _serve(eng):
    prompts, budgets = _stream()
    return [np.asarray(x) for x in
            eng.generate_many(prompts, max_new_tokens=budgets)]


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    """Seed 11's weights saved by each package's engine, and the JAX
    engines' ids: fresh on seed 11, and seed 3's engine after installing
    the port's snapshot."""
    d = tmp_path_factory.mktemp("snaps")
    (j3, _), (j11, t11) = _models(3), _models(11)
    jeng = jsched.ContinuousBatchingEngine(j11, **ENGINE_KW)
    jeng.save_weights_snapshot(str(d / "jax"), step=11)
    teng = tsched.ContinuousBatchingEngine(t11, device="cpu", **ENGINE_KW)
    teng.save_weights_snapshot(str(d / "port"), step=11)
    flipped = jsched.ContinuousBatchingEngine(j3, **ENGINE_KW)
    flipped.install_weights(flipped.load_weights_snapshot(str(d / "port")))
    return {"dir": d, "jax_fresh": _serve(jeng),
            "jax_from_port": _serve(flipped)}


class TestWeightSnapshots:
    def test_manifests_equal_across_packages(self, snaps):
        mj, mt = (json.load(open(snaps["dir"] / n / "manifest.json"))
                  for n in ("jax", "port"))
        assert mj["checksums"] == mt["checksums"]
        assert mj == mt
        assert _files(snaps["dir"] / "jax") == _files(snaps["dir"] / "port")

    def test_jax_snapshot_installs_in_the_port(self, snaps):
        eng = tsched.ContinuousBatchingEngine(_models(3)[1], device="cpu",
                                              **ENGINE_KW)
        eng.install_weights(eng.load_weights_snapshot(
            str(snaps["dir"] / "jax")))
        got = _serve(eng)
        for a, b in zip(snaps["jax_fresh"], got):
            np.testing.assert_array_equal(b, a)

    def test_port_snapshot_installs_in_jax(self, snaps):
        """The JAX engine that installed the port's snapshot (module
        fixture) serves the ids the port serves after its own install."""
        eng = tsched.ContinuousBatchingEngine(_models(3)[1], device="cpu",
                                              **ENGINE_KW)
        eng.install_weights(eng.load_weights_snapshot(
            str(snaps["dir"] / "port")))
        got = _serve(eng)
        for a, b, c in zip(snaps["jax_from_port"], got, snaps["jax_fresh"]):
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(b, c)

    def test_flipped_byte_raises_before_install(self, snaps, tmp_path):
        import shutil
        bad = tmp_path / "bad"
        shutil.copytree(snaps["dir"] / "jax", bad)
        leaf = bad / "leaf_2.npy"
        raw = bytearray(leaf.read_bytes())
        raw[-3] ^= 0x10
        leaf.write_bytes(bytes(raw))
        eng = tsched.ContinuousBatchingEngine(_models(3)[1], device="cpu",
                                              **ENGINE_KW)
        before = eng.weights
        with pytest.raises(ckpt.CheckpointCorruptError, match="leaf 2"):
            eng.load_weights_snapshot(str(bad))
        assert eng.weights is before

    def test_wrong_geometry_is_refused(self, snaps):
        other = LlamaForCausalLM(LlamaConfig.tiny(
            **dict(MICRO, intermediate_size=48)), device="cpu")
        eng = tsched.ContinuousBatchingEngine(other, device="cpu",
                                              **ENGINE_KW)
        with pytest.raises(ckpt.CheckpointCorruptError, match="shape"):
            eng.load_weights_snapshot(str(snaps["dir"] / "jax"))
        with pytest.raises(ValueError, match="tree structure"):
            eng.install_weights({"emb": eng.weights["emb"]})

    def test_install_rebinds_engines_sharing_a_model(self, snaps):
        """Two engines built from one model alias its parameters: a flip of
        one leaves the other (and the exported old weights) untouched, and
        a rollback to the export restores the old ids."""
        tm = _models(3)[1]
        a = tsched.ContinuousBatchingEngine(tm, device="cpu", **ENGINE_KW)
        b = tsched.ContinuousBatchingEngine(tm, device="cpu", **ENGINE_KW)
        assert a.weights["emb"].data_ptr() == b.weights["emb"].data_ptr()
        base = _serve(b)
        old = a.export_weights()
        a.install_weights(a.load_weights_snapshot(str(snaps["dir"] / "jax")))
        for x, y in zip(snaps["jax_fresh"], _serve(a)):
            np.testing.assert_array_equal(y, x)
        for x, y in zip(base, _serve(b)):
            np.testing.assert_array_equal(y, x)
        a.install_weights(old)
        for x, y in zip(base, _serve(a)):
            np.testing.assert_array_equal(y, x)
        assert old["emb"].data_ptr() == tm.llama.embed_tokens.weight \
            .data_ptr()

    @pytest.mark.parametrize("mk", ["layer", "multi"])
    def test_megakernel_pack_follows_the_flip(self, snaps, mk):
        """The megakernel's pointer tables are rebuilt over the new tensors:
        a flipped engine serves what a fresh engine on the new weights
        serves (the kernel's plain version on the CPU reads the pack)."""
        eng = tsched.ContinuousBatchingEngine(_models(3)[1], device="cpu",
                                              megakernel=mk, **ENGINE_KW)
        eng.install_weights(eng.load_weights_snapshot(
            str(snaps["dir"] / "jax")))
        fresh = tsched.ContinuousBatchingEngine(_models(11)[1], device="cpu",
                                                megakernel=mk, **ENGINE_KW)
        for x, y in zip(_serve(fresh), _serve(eng)):
            np.testing.assert_array_equal(y, x)

    def test_tp_export_joins_and_install_resplits(self, snaps):
        """Under tp = 2 the export joins the shards back into the full
        tensors (the single engine's snapshot, byte for byte) and an
        install splits the new weights over the shards again."""
        tm = _models(3)[1]
        one = tsched.ContinuousBatchingEngine(tm, device="cpu", **ENGINE_KW)
        two = tsched.ContinuousBatchingEngine(tm, device="cpu", tp=2,
                                              **ENGINE_KW)
        for x, y in zip(ckpt.tree_leaves(one.export_weights()),
                        ckpt.tree_leaves(two.export_weights())):
            assert torch.equal(x, y)
        two.install_weights(two.load_weights_snapshot(
            str(snaps["dir"] / "jax")))
        for x, y in zip(snaps["jax_fresh"], _serve(two)):
            np.testing.assert_array_equal(y, x)

"""PTQ calibration (paddle_tpu_torch.quantization.ptq) and
LLMEngine(quant_scales=) against paddle_tpu.quantization.ptq.

Replays tests/test_ptq.py (TestObservers, TestRoundTrip; TestModelZoo
waits for adapters, ROADMAP A7.2) on the reference suite's micro model
(`LlamaConfig.tiny(num_hidden_layers=1, hidden_size=32,
intermediate_size=64, num_attention_heads=2)`, seed 3, weights carried
across by name, f32 on the CPU), and exchanges calibration files across
the packages.

Exact: the weight scales (equal to quantize_weights' absmax scales and to
the JAX calibration's), greedy ids of calibrated engines (equal to the
absmax engine's and to the JAX int8 engine's), and scales read back from
a file saved by either package. The activation scales come from two f32
forwards whose products sum in different orders: held to rtol 1e-5.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.quantization import ptq as jptq
from paddle_tpu_torch import failsafe
from paddle_tpu_torch.convert import load_numpy_params
from paddle_tpu_torch.inference.scheduler import ContinuousBatchingEngine
from paddle_tpu_torch.inference.serving import LLMEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.pallas.quantized_matmul import quantize_weights
from paddle_tpu_torch.quantization import _ObservedLinear, ptq

torch.set_num_threads(1)

MICRO = dict(num_hidden_layers=1, hidden_size=32, intermediate_size=64,
             num_attention_heads=2)
KW = dict(max_len=64, page_size=8, max_batch=2)
_CACHE = {}


@pytest.fixture(autouse=True)
def _clean_faults():
    failsafe.reset()
    yield
    failsafe.reset()


def _pair():
    if "m" not in _CACHE:
        paddle.seed(3)
        jm = JaxLlama(JaxConfig.tiny(**MICRO))
        tm = LlamaForCausalLM(LlamaConfig.tiny(**MICRO), device="cpu")
        load_numpy_params(tm, {n: np.asarray(p.data)
                               for n, p in jm.named_parameters()})
        _CACHE["m"] = (jm, tm)
    return _CACHE["m"]


def _batches():
    rng = np.random.RandomState(7)
    return [rng.randint(0, 128, (2, 8)) for _ in range(2)]


@pytest.fixture(scope="module")
def calib():
    """(JAX calibration, port calibration) of the same weights on the
    same batches."""
    jm, tm = _pair()
    return jptq.calibrate(jm, sample_batches=_batches()), \
        ptq.calibrate(tm, sample_batches=_batches())


def _prompts(seed=0):
    return np.random.RandomState(seed).randint(0, 128, (2, 8)).astype(
        np.int64)


def _scales(c):
    return [(li, proj, c.weight_scale(li, proj))
            for li in range(c.n_layers) for proj in ptq.PROJ_KEYS] + \
        [(None, "head", c.weight_scale(None, "head"))]


class TestObservers:
    def test_channel_absmax_matches_quantize_weights(self):
        """Exact: the observer's reduction is quantize_weights' scale
        rule, the identity the byte-identical round trip rests on."""
        _, tm = _pair()
        w = tm.llama.layers[0].self_attn.q_proj.weight
        obs = ptq.ChannelAbsmaxObserver()
        obs._observe(w)
        _, sc = quantize_weights(w.detach().float())
        np.testing.assert_array_equal(obs.scales(), sc.numpy())

    def test_weight_scales_equal_jax(self, calib):
        """Exact: every leaf's weight scales equal the JAX calibration's."""
        jc, tc = calib
        for (li, proj, a), (_, _, b) in zip(_scales(jc), _scales(tc)):
            np.testing.assert_array_equal(b, np.asarray(a),
                                          err_msg=f"{li} {proj}")

    def test_calibrate_covers_every_projection(self, calib):
        _, tc = calib
        assert tc.n_layers == MICRO["num_hidden_layers"]
        for lay in tc.weight["layers"]:
            assert set(lay) == set(ptq.PROJ_KEYS)
        assert tc.weight["head"].shape == (128,)

    def test_activation_observers_saw_data(self, calib):
        """The activation observers saw the calibration forwards, with the
        JAX calibration's scales (rtol 1e-5: two f32 forwards)."""
        jc, tc = calib
        acts = tc.act["layers"][0]
        assert set(acts) == set(ptq.PROJ_KEYS)
        assert all(v is not None and v > 0 for v in acts.values())
        assert tc.act["head"] and tc.act["head"] > 0
        for proj in ptq.PROJ_KEYS:
            np.testing.assert_allclose(acts[proj],
                                       jc.act["layers"][0][proj], rtol=1e-5)
        np.testing.assert_allclose(tc.act["head"], jc.act["head"],
                                   rtol=1e-5)

    def test_model_left_unwrapped(self):
        _, tm = _pair()
        before = {n: p for n, p in tm.named_parameters()}
        ptq.calibrate(tm, [np.random.RandomState(1).randint(0, 128, (1, 6))])
        for lay in tm.llama.layers:
            for m in (lay.self_attn.q_proj, lay.self_attn.o_proj,
                      lay.mlp.down_proj):
                assert not isinstance(m, _ObservedLinear)
        assert not isinstance(tm.lm_head, _ObservedLinear)
        assert {n: p for n, p in tm.named_parameters()} == before


def _jax_ids(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


class TestRoundTrip:
    def test_calibrated_engine_byte_identical_to_absmax(self, calib):
        """Exact: the calibrated int8 engine's greedy ids equal the absmax
        engine's and the JAX int8 engine's."""
        jm, tm = _pair()
        p = _prompts()
        o1 = LLMEngine(tm, quant="int8", device="cpu", **KW).generate(
            p, max_new_tokens=8)
        o2 = LLMEngine(tm, quant="int8", quant_scales=calib[1],
                       device="cpu", **KW).generate(p, max_new_tokens=8)
        ref = _jax_ids("static", lambda: np.asarray(jserving.LLMEngine(
            jm, quant="int8", quant_scales=calib[0], **KW).generate(
                p, max_new_tokens=8)))
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_array_equal(o2, ref)

    def test_scheduler_engine_eats_calibration(self, calib):
        """Exact: ContinuousBatchingEngine passes quant_scales through;
        ids equal the absmax engine's and the JAX engine's."""
        jm, tm = _pair()
        kw = dict(KW, prefill_chunk=8)
        prompts = list(_prompts(1))
        ref = ContinuousBatchingEngine(tm, quant="int8", device="cpu",
                                       **kw).generate_many(
            prompts, max_new_tokens=6)
        eng = ContinuousBatchingEngine(tm, quant="int8", device="cpu",
                                       quant_scales=calib[1], **kw)
        out = eng.generate_many(prompts, max_new_tokens=6)
        assert eng.quant_scales is calib[1]
        jref = _jax_ids("cb", lambda: jsched.ContinuousBatchingEngine(
            jm, quant="int8", quant_scales=calib[0], **kw).generate_many(
                prompts, max_new_tokens=6))
        for a, b, c in zip(ref, out, jref):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, c)

    def test_save_load_roundtrip(self, calib, tmp_path):
        _, tm = _pair()
        tc = calib[1]
        c2 = ptq.CalibrationResult.load(tc.save(str(tmp_path / "c.npz")))
        for (li, proj, a), (_, _, b) in zip(_scales(tc), _scales(c2)):
            np.testing.assert_array_equal(b, a)
        assert c2.act == tc.act and c2.bits == 8
        o1 = LLMEngine(tm, quant="int8", device="cpu", **KW).generate(
            _prompts(), max_new_tokens=6)
        o2 = LLMEngine(tm, quant="int8", quant_scales=c2, device="cpu",
                       **KW).generate(_prompts(), max_new_tokens=6)
        np.testing.assert_array_equal(o1, o2)

    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_files_exchange_across_packages(self, calib, tmp_path,
                                            direction):
        """Exact: a calibration saved by one package loads in the other
        with the same scales, bits, layer count and activation meta."""
        jc, tc = calib
        src, loader = ((jc, ptq.CalibrationResult) if direction ==
                       "jax_to_port" else (tc, jptq.CalibrationResult))
        got = loader.load(src.save(str(tmp_path / "x.npz")))
        for (li, proj, a), (_, _, b) in zip(_scales(src), _scales(got)):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        assert (got.bits, got.n_layers, got.act) == \
            (src.bits, src.n_layers, src.act)

    def test_missing_leaf_keeps_absmax(self, calib):
        """A leaf the calibration lacks keeps the absmax scales; the
        others take the calibration's (here doubled, so it shows)."""
        _, tm = _pair()
        c = copy.deepcopy(calib[1])
        del c.weight["layers"][0]["wk"]
        c.weight["layers"][0]["wq"] = c.weight["layers"][0]["wq"] * 2
        eng = LLMEngine(tm, quant="int8", quant_scales=c, device="cpu", **KW)
        base = LLMEngine(tm, quant="int8", device="cpu", **KW)
        lay, ref = eng.weights["layers"][0], base.weights["layers"][0]
        np.testing.assert_array_equal(lay["wk"][1].numpy(),
                                      ref["wk"][1].numpy())
        np.testing.assert_array_equal(lay["wq"][1].numpy(),
                                      ref["wq"][1].numpy() * 2)
        np.testing.assert_array_equal(lay["wv"][0].numpy(),
                                      ref["wv"][0].numpy())

    def test_corrupt_calibration_typed(self, tmp_path):
        bad = tmp_path / "bad.npz"
        bad.write_bytes(b"not an npz at all")
        with pytest.raises(ptq.CalibrationError):
            ptq.CalibrationResult.load(str(bad))

    def test_wrong_geometry_scales_typed(self, calib):
        """A calibration of another geometry fails typed before the engine
        installs anything."""
        other = LlamaForCausalLM(LlamaConfig.tiny(
            num_hidden_layers=1, hidden_size=16, intermediate_size=32,
            num_attention_heads=2), device="cpu", seed=9)
        with pytest.raises(ptq.CalibrationError, match="out dim"):
            LLMEngine(other, quant="int8", quant_scales=calib[1],
                      device="cpu", **KW)

    def test_quant_scales_requires_int8(self, calib):
        _, tm = _pair()
        with pytest.raises(ValueError, match="int8"):
            LLMEngine(tm, quant=None, quant_scales=calib[1], device="cpu",
                      **KW)

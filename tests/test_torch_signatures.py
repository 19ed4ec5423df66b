"""Public signatures of paddle_tpu_torch against the JAX package's.

Exact (no numerics): for each ported callable, the reference's parameters
come first in the port, in the reference's order, with the same kinds and
defaults, so a positional call binds the same arguments in both packages.
The port may add parameters after them (its "port-only tail", e.g.
`device`); a parameter that exists only for JAX (`interpret`, the Pallas
interpreter switch) is left out of the comparison. The `sdpa` slot keeps
the reference's non-causal default.
"""
import inspect

import pytest

import paddle_tpu.inference.scheduler as jsched
import paddle_tpu.inference.serving as jserving
import paddle_tpu.inference.speculative as jspec
import paddle_tpu.ops.pallas as jpallas
import paddle_tpu.ops.pallas.paged_attention as jpa
import paddle_tpu_torch.inference.scheduler as tsched
import paddle_tpu_torch.inference.serving as tserving
import paddle_tpu_torch.inference.speculative as tspec
import paddle_tpu_torch.ops.pallas as tpallas
import paddle_tpu_torch.ops.pallas.paged_attention as tpa
import paddle_tpu.framework.random as jrnd
import paddle_tpu.models.gpt as jgpt
import paddle_tpu.models.train_step as jtrain
import paddle_tpu.nn.functional as jF
import paddle_tpu_torch.framework.random as trnd
import paddle_tpu_torch.models.gpt as tgpt
import paddle_tpu_torch.models.train_step as ttrain
import paddle_tpu_torch.nn.functional as tF
import paddle_tpu.models.bert as jbert
import paddle_tpu.nn.layer.transformer as jtr
import paddle_tpu.optimizer as jopt
import paddle_tpu_torch.models.bert as tbert
import paddle_tpu_torch.nn.transformer as ttr
import paddle_tpu_torch.optimizer as topt
import paddle_tpu.inference.adapters as jad
import paddle_tpu.inference.handoff as jho
import paddle_tpu.inference.tiering as jti
import paddle_tpu_torch.inference.adapters as tad
import paddle_tpu_torch.inference.handoff as tho
import paddle_tpu_torch.inference.tiering as tti
import paddle_tpu_torch.ops.lora as tlora

JAX_ONLY = {"interpret"}

PAIRS = {
    "LLMEngine.__init__": (jserving.LLMEngine.__init__,
                           tserving.LLMEngine.__init__),
    "ContinuousBatchingEngine.__init__": (
        jsched.ContinuousBatchingEngine.__init__,
        tsched.ContinuousBatchingEngine.__init__),
    "ContinuousBatchingEngine.add_request": (
        jsched.ContinuousBatchingEngine.add_request,
        tsched.ContinuousBatchingEngine.add_request),
    "ContinuousBatchingEngine.generate_many": (
        jsched.ContinuousBatchingEngine.generate_many,
        tsched.ContinuousBatchingEngine.generate_many),
    "ragged_paged_attention_reference": (
        jpa.ragged_paged_attention_reference,
        tpa.ragged_paged_attention_reference),
    "ragged_paged_attention": (jpa.ragged_paged_attention,
                               tpa.ragged_paged_attention),
    "spec_verify_attention": (jpa.spec_verify_attention,
                              tpa.spec_verify_attention),
    "paged_attention": (jpa.paged_attention, tpa.paged_attention),
    "ragged_causal_mask": (jpa.ragged_causal_mask, tpa.ragged_causal_mask),
    "rejection_sample": (jspec.rejection_sample, tspec.rejection_sample),
    "Drafter.timed_propose": (jspec.Drafter.timed_propose,
                              tspec.Drafter.timed_propose),
    "NGramDrafter.__init__": (jspec.NGramDrafter.__init__,
                              tspec.NGramDrafter.__init__),
    "PrefixCacheDrafter.__init__": (jspec.PrefixCacheDrafter.__init__,
                                    tspec.PrefixCacheDrafter.__init__),
    "ModelDrafter.__init__": (jspec.ModelDrafter.__init__,
                              tspec.ModelDrafter.__init__),
    "resolve_drafter": (jspec.resolve_drafter, tspec.resolve_drafter),
    "GPTConfig.__init__": (jgpt.GPTConfig.__init__, tgpt.GPTConfig.__init__),
    "GPTConfig.tiny": (jgpt.GPTConfig.tiny, tgpt.GPTConfig.tiny),
    "GPTConfig.gpt3_1p3b": (jgpt.GPTConfig.gpt3_1p3b,
                            tgpt.GPTConfig.gpt3_1p3b),
    "GPTForCausalLM.__init__": (jgpt.GPTForCausalLM.__init__,
                                tgpt.GPTForCausalLM.__init__),
    "GPTForCausalLM.forward": (jgpt.GPTForCausalLM.forward,
                               tgpt.GPTForCausalLM.forward),
    "SpmdTrainer.step": (jtrain.SpmdTrainer.step, ttrain.SpmdTrainer.step),
    "F.dropout": (jF.dropout, tF.dropout),
    "F.layer_norm": (jF.layer_norm, tF.layer_norm),
    "F.gelu": (jF.gelu, tF.gelu),
    "random.key_scope": (jrnd.key_scope, trnd.key_scope),
    "random.seed": (jrnd.seed, trnd.seed),
    "random.Generator.__init__": (jrnd.Generator.__init__,
                                  trnd.Generator.__init__),
    "sdpa": (jpallas._sdpa_pallas, tpallas.sdpa),
    "F.tanh": (jF.tanh, tF.tanh),
    "F.relu": (jF.relu, tF.relu),
    "F.cross_entropy": (jF.cross_entropy, tF.cross_entropy),
    "F.scaled_dot_product_attention": (jF.scaled_dot_product_attention,
                                       tF.scaled_dot_product_attention),
    "MultiHeadAttention.__init__": (jtr.MultiHeadAttention.__init__,
                                    ttr.MultiHeadAttention.__init__),
    "MultiHeadAttention.forward": (jtr.MultiHeadAttention.forward,
                                   ttr.MultiHeadAttention.forward),
    "MultiHeadAttention.gen_cache": (jtr.MultiHeadAttention.gen_cache,
                                     ttr.MultiHeadAttention.gen_cache),
    "TransformerEncoderLayer.__init__": (
        jtr.TransformerEncoderLayer.__init__,
        ttr.TransformerEncoderLayer.__init__),
    "TransformerEncoderLayer.forward": (jtr.TransformerEncoderLayer.forward,
                                        ttr.TransformerEncoderLayer.forward),
    "TransformerEncoder.__init__": (jtr.TransformerEncoder.__init__,
                                    ttr.TransformerEncoder.__init__),
    "TransformerEncoder.forward": (jtr.TransformerEncoder.forward,
                                   ttr.TransformerEncoder.forward),
    "BertConfig.__init__": (jbert.BertConfig.__init__,
                            tbert.BertConfig.__init__),
    "BertConfig.base": (jbert.BertConfig.base, tbert.BertConfig.base),
    "BertConfig.tiny": (jbert.BertConfig.tiny, tbert.BertConfig.tiny),
    "BertEmbeddings.forward": (jbert.BertEmbeddings.forward,
                               tbert.BertEmbeddings.forward),
    "BertModel.__init__": (jbert.BertModel.__init__,
                           tbert.BertModel.__init__),
    "BertModel.forward": (jbert.BertModel.forward, tbert.BertModel.forward),
    "BertForMaskedLM.__init__": (jbert.BertForMaskedLM.__init__,
                                 tbert.BertForMaskedLM.__init__),
    "BertForMaskedLM.forward": (jbert.BertForMaskedLM.forward,
                                tbert.BertForMaskedLM.forward),
    "BertForSequenceClassification.__init__": (
        jbert.BertForSequenceClassification.__init__,
        tbert.BertForSequenceClassification.__init__),
    "BertForSequenceClassification.forward": (
        jbert.BertForSequenceClassification.forward,
        tbert.BertForSequenceClassification.forward),
    "Optimizer.__init__": (jopt.Optimizer.__init__, topt.Optimizer.__init__),
    "Optimizer.step": (jopt.Optimizer.step, topt.Optimizer.step),
    "Optimizer.clear_grad": (jopt.Optimizer.clear_grad,
                             topt.Optimizer.clear_grad),
    "Optimizer.set_lr": (jopt.Optimizer.set_lr, topt.Optimizer.set_lr),
    "Optimizer.minimize": (jopt.Optimizer.minimize,
                           topt.Optimizer.minimize),
    "L2Decay.__init__": (jopt.L2Decay.__init__, topt.L2Decay.__init__),
    "L1Decay.__init__": (jopt.L1Decay.__init__, topt.L1Decay.__init__),
    "Adam.__init__": (jopt.Adam.__init__, topt.Adam.__init__),
    "AdamW.__init__": (jopt.AdamW.__init__, topt.AdamW.__init__),
}

# multi-LoRA adapters, KV-page handoff and KV tiering (ROADMAP A7.2, A7.6,
# A7.4): the modules' functions and classes, and the engine's methods
_CB = "ContinuousBatchingEngine."
for _name in ("export_request", "export_inflight", "submit_resume",
              "export_kv_pages", "abort_handoff", "release_handoff",
              "import_kv_pages", "demote_request", "restore_request",
              "register_adapter", "load_adapter", "evict_adapter",
              "pin_adapter", "attach_prefix_index"):
    PAIRS[_CB + _name] = (getattr(jsched.ContinuousBatchingEngine, _name),
                          getattr(tsched.ContinuousBatchingEngine, _name))
for _mods, _names in (
        ((jad, tad), ("target_dims", "engine_target_dims",
                      "make_lora_adapter", "save_adapter",
                      "load_adapter_file", "AdapterPool.__init__",
                      "AdapterPool.install", "AdapterPool.evict",
                      "AdapterPool.slot", "AdapterPool.pin",
                      "AdapterPool.acquire", "AdapterPool.release",
                      "AdapterPool.stats")),
        ((jho, tho), ("checksum_payload", "verify_payload", "payload_bytes",
                      "negotiate", "DeviceTransport.gather",
                      "DeviceTransport.place", "StoreKVTransport.__init__",
                      "StoreKVTransport.send", "StoreKVTransport.recv",
                      "StoreKVTransport.delete")),
        ((jti, tti), ("resolve_tier", "KVTierStore.__init__",
                      "KVTierStore.put", "KVTierStore.get",
                      "KVTierStore.delete", "KVTierStore.stats"))):
    for _name in _names:
        _pair = []
        for _m in _mods:
            _obj = _m
            for _part in _name.split("."):
                _obj = getattr(_obj, _part)
            _pair.append(_obj)
        PAIRS[_name] = tuple(_pair)
PAIRS["lora_delta"] = (jad.lora_delta, tlora.lora_delta)
PAIRS["lora_apply"] = (jad.lora_apply, tlora.lora_apply)


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()
            if p.name not in JAX_ONLY]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_reference_parameters_lead_in_order(name):
    ref, port = (_params(f) for f in PAIRS[name])
    assert port[:len(ref)] == ref, (
        f"{name}: the port's leading parameters {port[:len(ref)]} differ "
        f"from the reference's {ref}")
    # the tail holds only keyword-usable port-only parameters
    for pname, kind, _ in port[len(ref):]:
        assert kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                        inspect.Parameter.KEYWORD_ONLY), (name, pname)


def test_unported_reference_parameters_are_taken():
    """The reference's parameters the port refuses (use_pallas) are in its
    signatures, so a reference call gets a typed refusal, never a
    TypeError; so is the fleet prefix index's engine hook
    (attach_prefix_index, A7.5). tp_mode and tp_compress are taken (tensor
    parallelism is ported): ignored at tp = 1, as the reference ignores
    them, and checked at tp > 1. tier_dir and tier_host_cap_mb are taken
    (KV tiering is ported): without kv_tier they configure nothing, as in
    the reference."""
    llm = inspect.signature(tserving.LLMEngine.__init__).parameters
    cb = inspect.signature(tsched.ContinuousBatchingEngine.__init__).parameters
    for p in ("use_pallas", "tp_mode", "tp_compress"):
        assert p in llm
    for p in ("drafter", "spec_adaptive", "tier_dir", "tier_host_cap_mb"):
        assert p in cb
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    kw = dict(max_len=32, page_size=8, max_batch=1, device="cpu")
    for bad in (True, False):
        with pytest.raises(ValueError, match="use_pallas"):
            tserving.LLMEngine(model, use_pallas=bad, **kw)
    for tkw in (dict(tp_mode="psum"), dict(tp_compress="int8")):
        eng = tserving.LLMEngine(model, **tkw, **kw)
        assert (eng.tp_mode, eng.tp_compress) == (None, None)
    with pytest.raises(ValueError, match="psum"):
        tserving.LLMEngine(model, tp=2, tp_compress="int8", **kw)
    for tkw in (dict(tier_dir="kv_tier"), dict(tier_host_cap_mb=8)):
        eng = tsched.ContinuousBatchingEngine(model, **tkw, **kw)
        assert eng.health()["kv_tier"] is None
    with pytest.raises(NotImplementedError, match="A7.5"):
        eng.attach_prefix_index(None, "r0")
    # a positional call in the reference's order binds the same way
    eng = tserving.LLMEngine(model, 32, 8, 1, None, None, None, "float32",
                             16, device="cpu")
    assert eng.flash_prefill_min == 16


def test_sdpa_slot_default_is_non_causal():
    ref = inspect.signature(jpallas._sdpa_pallas).parameters["causal"]
    port = inspect.signature(tpallas.sdpa).parameters["causal"]
    assert port.default is ref.default is False

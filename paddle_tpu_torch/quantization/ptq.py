"""PTQ calibration for the int8 serving stack.

Counterpart of `paddle_tpu/quantization/ptq.py`. `calibrate(model,
sample_batches)` runs a per-output-channel weight observer over every
projection the serving engine quantizes (wq/wk/wv/wo/gate/up/down and the
lm_head) and, when sample batches are given, absmax activation observers
hooked over the same Linears for one forward pass per batch. The result's
per-channel int8 scales are what `LLMEngine(quant="int8",
quant_scales=result)` takes (the `quantize_weights` convention: symmetric,
per output channel, absmax / 127, clipped to [-127, 127]).

The weight observer reduces over the same values `quantize_weights` does,
so a calibrated engine's greedy output equals the absmax engine's. The
file format of `CalibrationResult.save` / `load` is the reference's (one
.npz of scales with a JSON meta blob): a calibration saved by either
package loads in the other and gives the same scales.
"""
import json

import numpy as np
import torch

from . import BaseObserver, _AbsmaxActObserver, _ObservedLinear

# engine projection keys, in _snapshot_llama's layer order; "head" is the
# lm_head
PROJ_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
QMAX = 127.0


class CalibrationError(RuntimeError):
    """Typed calibration failures (corrupt file, geometry mismatch)."""


class ChannelAbsmaxObserver(BaseObserver):
    """Per-output-channel absmax weight observer: observes [in, out]
    tensors and reports scales [out] = absmax(axis=0) / 127, the
    quantize_weights convention."""

    def __init__(self, quant_bits=8):
        super().__init__(quant_bits)
        self._absmax = None

    def _observe(self, x):
        am = torch.amax(torch.abs(x.detach().float()), dim=0)
        self._absmax = am if self._absmax is None \
            else torch.maximum(self._absmax, am)

    @property
    def observed(self):
        return self._absmax is not None

    def scales(self):
        # divided on the observed tensor's device, as quantize_weights
        # divides (CUDA divides by a scalar through its reciprocal)
        qmax = 2 ** (self.quant_bits - 1) - 1
        return (self._absmax / float(qmax)).cpu().numpy().astype(np.float32)


class CalibrationResult:
    """Per-channel int8 weight scales (and absmax activation scales) for
    one model geometry: what `LLMEngine(quant="int8", quant_scales=...)`
    takes and what `save` / `load` round-trip."""

    def __init__(self, weight_scales, act_scales=None, bits=8,
                 n_layers=None):
        self.weight = weight_scales     # {"layers": [{proj: np [out]}],
        #                                  "head": np [vocab]}
        self.act = act_scales or {}     # {"layers": [{proj: float}],
        #                                  "head": float} (absmax / qmax)
        self.bits = int(bits)
        self.n_layers = (len(self.weight["layers"])
                         if n_layers is None else int(n_layers))

    def weight_scale(self, li, proj):
        """Scales [out] for layer `li`'s projection (the head with li=None
        or proj "head"); None when the calibration lacks it (the engine
        then keeps the absmax scales for that leaf)."""
        if li is None or proj == "head":
            return self.weight.get("head")
        if li >= len(self.weight["layers"]):
            return None
        return self.weight["layers"][li].get(proj)

    def save(self, path):
        """One .npz of scales and a JSON meta blob (bits, layers, act)."""
        arrs = {}
        for li, lay in enumerate(self.weight["layers"]):
            for proj, sc in lay.items():
                arrs[f"layer{li}.{proj}"] = np.asarray(sc, np.float32)
        if self.weight.get("head") is not None:
            arrs["head"] = np.asarray(self.weight["head"], np.float32)
        arrs["__meta__"] = np.frombuffer(json.dumps(
            {"bits": self.bits, "n_layers": self.n_layers,
             "act": self.act}).encode(), np.uint8)
        np.savez(path, **arrs)
        return path

    @classmethod
    def load(cls, path):
        try:
            data = np.load(path if str(path).endswith(".npz")
                           else str(path) + ".npz")
            meta = json.loads(bytes(data["__meta__"]).decode())
            n_layers = int(meta["n_layers"])
            layers = [{} for _ in range(n_layers)]
            head = None
            for key in data.files:
                if key == "__meta__":
                    continue
                if key == "head":
                    head = np.asarray(data[key], np.float32)
                    continue
                lay, _, proj = key.partition(".")
                layers[int(lay[len("layer"):])][proj] = np.asarray(
                    data[key], np.float32)
        except (OSError, KeyError, ValueError,
                json.JSONDecodeError) as e:
            raise CalibrationError(
                f"calibration {path!r} unreadable/corrupt "
                f"({type(e).__name__}: {e})") from e
        return cls({"layers": layers, "head": head},
                   act_scales=meta.get("act"), bits=meta.get("bits", 8),
                   n_layers=n_layers)


def quantize_with_scales(w, scales):
    """Symmetric int8 quantization of a [in, out] weight under given
    per-output-channel scales, on w's device. The same clip and round as
    quantize_weights; raises CalibrationError when the scale vector does
    not match the weight's out dim (a calibration of another geometry
    fails before anything installs). Returns (int8 [in, out], scales [out]
    f32)."""
    scales = np.asarray(scales, np.float32).reshape(-1)
    if scales.shape[0] != w.shape[-1]:
        raise CalibrationError(
            f"scale vector of {scales.shape[0]} channels does not "
            f"match weight out dim {w.shape[-1]} (calibration from a "
            "different model geometry?)")
    w = w.float()
    sc = torch.from_numpy(scales.copy()).to(w.device)
    wq = torch.clamp(torch.round(w / torch.clamp(sc, min=1e-12)),
                     -QMAX, QMAX)
    return wq.to(torch.int8), sc


def _llama_linears(model):
    """[(li or None, proj key, Linear)] over every projection the serving
    snapshot quantizes, in snapshot order."""
    out = []
    for li, layer in enumerate(model.llama.layers):
        a = layer.self_attn
        out += [(li, "wq", a.q_proj), (li, "wk", a.k_proj),
                (li, "wv", a.v_proj), (li, "wo", a.o_proj),
                (li, "wg", layer.mlp.gate_proj),
                (li, "wu", layer.mlp.up_proj),
                (li, "wd", layer.mlp.down_proj)]
    out.append((None, "head", model.lm_head))
    return out


_ATTRS = {"wq": "q_proj", "wk": "k_proj", "wv": "v_proj", "wo": "o_proj",
          "wg": "gate_proj", "wu": "up_proj", "wd": "down_proj"}


@torch.no_grad()
def calibrate(model, sample_batches=None, bits=8):
    """Run the PTQ observers over a LlamaForCausalLM and return the
    engine's scales as a CalibrationResult.

    Weight pass: a ChannelAbsmaxObserver per projection (per-output-
    channel absmax / qmax: the quantize_weights reduction, so
    `LLMEngine(quant="int8", quant_scales=calibrate(model))` equals the
    absmax engine).

    Activation pass (sample_batches: an iterable of [b, t] int token
    arrays): every projection Linear is wrapped in place by an
    `_ObservedLinear` with an `_AbsmaxActObserver`, the model runs one
    forward per batch on its own device, the running absmax scales are
    read out, and the wrappers are removed: the model leaves as it
    arrived. The serving engine's int8 path is weight-only and does not
    consume the activation scales."""
    sites = _llama_linears(model)
    layers = [{} for _ in model.llama.layers]
    head = None
    for li, proj, lin in sites:
        obs = ChannelAbsmaxObserver(bits)
        obs._observe(lin.weight)
        sc = obs.scales()
        if li is None:
            head = sc
        else:
            layers[li][proj] = sc
    act = None
    if sample_batches is not None:
        device = model.lm_head.weight.device
        wrapped = []                    # (parent, attr, linear)
        acc = {}
        for li, proj, lin in sites:
            if li is None:
                parent, attr = model, "lm_head"
            elif proj in ("wq", "wk", "wv", "wo"):
                parent, attr = model.llama.layers[li].self_attn, _ATTRS[proj]
            else:
                parent, attr = model.llama.layers[li].mlp, _ATTRS[proj]
            wrapper = _ObservedLinear(lin, _AbsmaxActObserver(bits))
            setattr(parent, attr, wrapper)
            wrapped.append((parent, attr, lin))
            acc[(li, proj)] = wrapper.act_observer
        try:
            model.eval()
            for batch in sample_batches:
                model(torch.as_tensor(np.asarray(batch, np.int64),
                                      device=device))
        finally:
            for parent, attr, lin in wrapped:
                setattr(parent, attr, lin)
        act = {"layers": [{} for _ in model.llama.layers], "head": None}
        for (li, proj), obs in acc.items():
            s = float(obs.scales()) if obs.observed else None
            if li is None:
                act["head"] = s
            else:
                act["layers"][li][proj] = s
    return CalibrationResult({"layers": layers, "head": head},
                             act_scales=act, bits=bits)

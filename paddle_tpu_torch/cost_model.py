"""The cost-model planner: an analytic-plus-measured roofline over (model,
mesh, plan) triples, and the enumerate-and-prune search over the parallel
and serving knobs.

Counterpart of `paddle_tpu/cost_model.py`, whole: the same dataclasses,
JSON forms ("kind" tags), arithmetic (term for term and in the same order,
so the same inputs give the reference's floats exactly) and search. Three
layers:

1. **Declarative plans**: `Plan` (training: dp x mp x pp x sharding plus
   grad_compress / grad_accum / stage) and `EngineSpec` (serving: tp x
   topology x megakernel x decode_block plus the prefill:decode split).
   `SpmdTrainer(plan=)` consumes a `Plan`; `EngineSpec.fleet_spec()` is
   exactly the dict `inference.fleet.build_engine_from_spec` takes, so a
   searched spec and a hand-written dict with the same fields build the
   same engine.

2. **Calibrated cost model**: `Calibration` holds the hardware constants
   and the measured tables (collective GB/s by payload, measured/predicted
   residuals); `predict_train_step` / `predict_serving` combine them with
   the analytic roofline (FLOPs from the config, bytes from dtype / quant,
   collective volume from the plan's split). Every prediction carries a
   per-term breakdown (`why()`) and an HBM footprint checked against a
   hard fit constraint.

3. **Plan search**: `search_plan(model_cfg, mesh, mode=...)` enumerates the
   feasible plans (divisibility and HBM pruning) and ranks them.

Backends: `"cuda"` (the default, as for every entry point of the port:
the H100 SXM5 80 GB) and `"cpu"` (only when asked; the reference's
nominal CPU entry, unchanged). The port keeps no TPU entry.
`Calibration.load()` reads `calib/h100.json` beside this module (or
`$PADDLE_TPU_CALIB`) and `calib/h100_residuals.json`; the JAX package's
CPU and TPU tables are never read.

`CostModel.analyze` counts FLOPs with `torch.utils.flop_counter`;
`measure_peak_flops` times a matmul with CUDA events.

`python -m paddle_tpu_torch.cost_model --check` is the self-test: it loads
the calibration, searches a tiny config in both modes and round-trips the
winners through JSON.
"""
import dataclasses
import json
import math
import os
import warnings

__all__ = [
    "CostModel", "Plan", "EngineSpec", "PlanCost", "RankedPlan",
    "Calibration", "predict_train_step", "predict_serving",
    "search_plan", "brute_force_plans", "size_fleet",
    "model_cfg_from_fleet_spec", "spec_from_fleet_dict",
    "DEFAULT_CALIB_PATH", "DEFAULT_RESIDUALS_PATH",
]

_CALIB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "calib")
DEFAULT_CALIB_PATH = os.path.join(_CALIB_DIR, "h100.json")
DEFAULT_RESIDUALS_PATH = os.path.join(_CALIB_DIR, "h100_residuals.json")

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
                "float64": 8}


def _dtype_bytes(dtype):
    return _DTYPE_BYTES.get(str(dtype).replace("torch.", ""), 4)


# --------------------------------------------------------------------------
# declarative plans
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Plan:
    """One TRAINING parallel plan: the dp x mp x pp x sharding mesh split
    plus the trainer knobs the search ranges over.  `SpmdTrainer(model,
    mesh, plan=p)` consumes it; `p.mesh_axes()` is the trainer's mesh (an
    axis dict)."""
    dp: int = 1                       # data-parallel degree ("data")
    mp: int = 1                       # tensor/model parallel ("model")
    pp: int = 1                       # pipeline degree ("pipe")
    sharding: int = 1                 # ZeRO axis degree ("sharding")
    sharding_stage: int = 2           # 1/2/3 (optimizer/grad/param)
    grad_compress: object = None      # None | "int8"
    grad_accum: int = 1               # deferred-sync microbatches
    micro_batch_size: object = None   # pipeline microbatch rows
    pp_schedule: str = "gpipe"        # gpipe | 1f1b | interleave
    virtual_pp_degree: int = 1
    recompute: bool = False

    def devices(self):
        return self.dp * self.mp * self.pp * self.sharding

    def mesh_axes(self):
        """The mesh axis dict this plan needs."""
        return {"data": self.dp, "pipe": self.pp,
                "sharding": self.sharding, "model": self.mp}

    def trainer_kwargs(self):
        """The exact `SpmdTrainer.__init__` knobs this plan pins — a
        trainer built from the plan and one built from these kwargs are
        byte-identical by construction."""
        return dict(sharding_stage=self.sharding_stage,
                    grad_compress=self.grad_compress,
                    grad_accum=self.grad_accum,
                    micro_batch_size=self.micro_batch_size,
                    pp_schedule=self.pp_schedule,
                    virtual_pp_degree=self.virtual_pp_degree,
                    recompute=self.recompute)

    def build_mesh(self, devices=None):
        """The trainer's mesh: `mesh_axes()` (the port's `SpmdTrainer`
        takes an axis dict). Multi-device meshes wait for the training and
        distributed stack (ROADMAP A8): any axis above 1 raises."""
        axes = self.mesh_axes()
        big = {a: n for a, n in axes.items() if n > 1}
        if big:
            raise NotImplementedError(
                f"Plan.build_mesh: mesh axes {big} need multi-device "
                f"training, which is not ported yet (ROADMAP A8)")
        return axes

    def to_json(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d):
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown Plan fields {sorted(unknown)}")
        return cls(**d)

    def save(self, path):
        with open(path, "w") as f:
            json.dump({"kind": "train_plan", **self.to_json()}, f,
                      indent=1, sort_keys=True)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            d = json.load(f)
        if d.pop("kind", "train_plan") != "train_plan":
            raise ValueError(f"{path} is not a training Plan")
        return cls.from_json(d)


@dataclasses.dataclass
class EngineSpec:
    """One SERVING plan: model + engine geometry + the searched knobs
    (tp x topology x megakernel x decode_block + the prefill:decode
    split), as plain data.

    `fleet_spec()` is exactly the `{"model":..., "engine":...}` dict
    `inference.fleet.build_engine_from_spec` consumes (and
    `spawn_fleet` ships), so the searcher's output IS the fleet's
    worker config; `build()` constructs the engine in-process through
    that same function, making hand-built vs searched engines
    byte-identical when the fields agree."""
    # -- model (build_engine_from_spec model half)
    model: dict = dataclasses.field(
        default_factory=lambda: {"preset": "tiny", "seed": 0})
    # -- engine geometry
    max_len: int = 1024
    page_size: int = 128
    max_batch: int = 8
    quant: object = None              # None | "int8"
    weight_dtype: object = None       # None | "bfloat16" | ...
    # -- the searched surface
    tp: int = 1
    tp_mode: str = "exact"
    tp_compress: object = None
    megakernel: object = False        # False | "layer" | "multi" | None
    decode_block: int = 1
    speculate: object = None
    drafter: str = "ngram"
    # -- fleet topology: replicas engines total; prefill/decode > 0
    # -- means the disaggregated split (prefill + decode == replicas)
    replicas: int = 1
    prefill: int = 0
    decode: int = 0
    # -- passthrough for knobs outside the searched surface (kv_tier,
    # -- adapters, queue_limit, ...): ride into engine kwargs verbatim
    engine_extra: dict = dataclasses.field(default_factory=dict)

    def devices(self):
        return self.tp * max(1, self.replicas)

    def topology(self):
        """EngineRouter(topology=) dict, or None when not disaggregated."""
        if self.prefill > 0 and self.decode > 0:
            return {"prefill": self.prefill, "decode": self.decode}
        return None

    def engine_kwargs(self):
        """The per-engine `ContinuousBatchingEngine` kwargs (everything
        but the model and the router-level topology)."""
        kw = dict(max_len=self.max_len, page_size=self.page_size,
                  max_batch=self.max_batch, quant=self.quant,
                  decode_block=self.decode_block)
        if self.weight_dtype is not None:
            kw["weight_dtype"] = self.weight_dtype
        if self.tp > 1:
            kw.update(tp=self.tp, tp_mode=self.tp_mode,
                      tp_compress=self.tp_compress)
        if self.megakernel not in (False, None):
            kw["megakernel"] = self.megakernel
        elif self.megakernel is False:
            kw["megakernel"] = False
        if self.speculate:
            kw.update(speculate=self.speculate, drafter=self.drafter)
        kw.update(self.engine_extra)
        return kw

    def fleet_spec(self):
        """The build_engine_from_spec / spawn_fleet worker dict."""
        return {"model": dict(self.model), "engine": self.engine_kwargs()}

    def build(self):
        """Construct the engine in-process through the SAME factory the
        fleet workers use — one construction path, byte-identical. The
        engine runs on CUDA unless `engine_extra` carries `device`."""
        from .inference.fleet import build_engine_from_spec
        return build_engine_from_spec(self.fleet_spec())

    def to_json(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d):
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown EngineSpec fields {sorted(unknown)}")
        return cls(**d)

    def save(self, path):
        with open(path, "w") as f:
            json.dump({"kind": "engine_spec", **self.to_json()}, f,
                      indent=1, sort_keys=True)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            d = json.load(f)
        if d.pop("kind", "engine_spec") != "engine_spec":
            raise ValueError(f"{path} is not an EngineSpec")
        return cls.from_json(d)

    @classmethod
    def from_model_cfg(cls, cfg, seed=0, **kw):
        """Spec whose model half round-trips `cfg` exactly (every
        LlamaConfig field is a plain scalar, so the worker rebuilds the
        same geometry from data alone)."""
        return cls(model={"preset": "config", "seed": int(seed),
                          **_cfg_fields(cfg)}, **kw)


@dataclasses.dataclass
class PlanCost:
    """One prediction: total objective ms, the per-term breakdown (the
    'why'), and the HBM footprint vs the fit constraint."""
    total_ms: float
    breakdown: dict                   # term -> ms (or unitless note)
    hbm_gb: float
    hbm_cap_gb: float
    fits: bool
    dominant: str                     # largest breakdown term
    meta: dict = dataclasses.field(default_factory=dict)

    def why(self):
        tot = sum(v for v in self.breakdown.values()) or 1.0
        parts = sorted(self.breakdown.items(), key=lambda kv: -kv[1])[:3]
        frac = ", ".join(f"{k} {100 * v / tot:.0f}%" for k, v in parts)
        fit = (f"hbm {self.hbm_gb:.2f}/{self.hbm_cap_gb:.0f} GB"
               if self.fits else
               f"DOES NOT FIT ({self.hbm_gb:.2f} > {self.hbm_cap_gb:.0f} GB)")
        return f"{self.dominant}-bound ({frac}); {fit}"


@dataclasses.dataclass
class RankedPlan:
    plan: object                      # Plan | EngineSpec
    cost: PlanCost
    rank: int = 0

    def why(self):
        return self.cost.why()


# --------------------------------------------------------------------------
# calibration: measured tables feeding the analytic roofline
# --------------------------------------------------------------------------

# nominal hardware constants per backend — the uncalibrated floor; a
# loaded calibration file overrides whatever it measured
_NOMINAL = {
    # the H100 SXM5 80 GB. peak_flops (bf16 dense, no sparsity), hbm_gbps
    # and hbm_cap_gb: H100 SXM5 datasheet. coll_gbps, coll_lat_ms,
    # host_block_ms and mfu: measured on one "NVIDIA H100 80GB HBM3,
    # 700.00 W" card by tools/calibrate_h100.py (calib/h100.json carries
    # them with their sources and run id). The port's tp shards run one
    # after another on one card, so coll_gbps / coll_lat_ms price an
    # on-card reassembly (the shards' concatenation), not a link between
    # cards.
    "cuda": dict(peak_flops=989e12, hbm_gbps=3350.0, hbm_cap_gb=80.0,
                 coll_gbps=1355.2746040592713, coll_lat_ms=0.020495359897613526,
                 host_block_ms=8.040361425641336, mfu=0.8671015641934556),
    # CPU: bench.py's nominal 1 TF peak; hbm = typical measured memcpy;
    # cap generous (host RAM) so CPU searches are not memory-pruned
    "cpu": dict(peak_flops=1e12, hbm_gbps=12.0, hbm_cap_gb=64.0,
                coll_gbps=2.0, coll_lat_ms=0.08, host_block_ms=3.0,
                mfu=0.45),
}


def _backend(backend):
    """The backend a calibration prices: "cuda" unless the caller asks for
    "cpu" (no environment or device guess)."""
    backend = "cuda" if backend is None else str(backend)
    if backend not in _NOMINAL:
        raise ValueError(f"cost_model: unknown backend {backend!r}; the "
                         f"port knows 'cuda' (the default) and 'cpu'")
    return backend


def _value(v):
    """A calibration entry: a number, or {"value": number, "source": ...}
    (the port's files name each value's source)."""
    return v["value"] if isinstance(v, dict) else v


class Calibration:
    """Measured inputs for the roofline.

    collectives: rows from collective_bench.py --calib-out —
      {"verb": "allreduce"|"reducescatter", "kind": "exact"|"int8",
       "size_bytes": wire bytes/rank, "gbps": measured} — interpolated
      log-linearly in size, clamped at the measured ends.
    residuals: plan_sweep.py's measured/predicted ratios per stage
      ({"serving": {"tpot": r, "ttft": r}, "training": {"step": r}}),
      multiplied into predictions so the model tracks the machine it
      last ran on (ranking is scale-invariant; residuals buy absolute
      accuracy).
    """

    def __init__(self, backend=None, collectives=None, residuals=None,
                 source="nominal", **overrides):
        self.backend = _backend(backend)
        nom = _NOMINAL[self.backend]
        self.peak_flops = nom["peak_flops"]
        self.hbm_gbps = nom["hbm_gbps"]
        self.hbm_cap_gb = nom["hbm_cap_gb"]
        self.coll_gbps = nom["coll_gbps"]
        self.coll_lat_ms = nom["coll_lat_ms"]
        self.host_block_ms = nom["host_block_ms"]
        self.mfu = nom["mfu"]
        for k, v in overrides.items():
            if v is not None:
                setattr(self, k, float(v))
        self.collectives = list(collectives or [])
        self.residuals = dict(residuals or {})
        self.source = source

    # -- loading -----------------------------------------------------------
    @classmethod
    def load(cls, path=None, residuals_path=None, backend=None):
        """Load the calibration file (default: the checked-in
        calib/h100.json beside this module, or $PADDLE_TPU_CALIB).  The
        planner never *silently* runs uncalibrated: a missing file
        warns once and falls back to nominal constants, and
        `.source` always says which inputs are live. A file (and a
        residuals file) measured on another backend than the one asked
        for is left out: its figures are not this backend's."""
        path = path or os.environ.get("PADDLE_TPU_CALIB",
                                      DEFAULT_CALIB_PATH)
        residuals_path = residuals_path or DEFAULT_RESIDUALS_PATH
        rows, over, src = [], {}, "nominal"
        if os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            if backend is None or d.get("backend") in (None, backend):
                rows = list(d.get("collectives") or [])
                over = {k: _value(d[k]) for k in (
                    "peak_flops", "hbm_gbps", "hbm_cap_gb", "coll_lat_ms",
                    "host_block_ms", "mfu") if k in d}
                backend = backend or d.get("backend")
                src = f"calib:{os.path.basename(path)}"
        else:
            warnings.warn(
                f"cost_model: no calibration file at {path} — falling "
                f"back to nominal constants (run benchmarks/"
                f"collective_bench.py --calib-out to measure)",
                stacklevel=2)
        resid = {}
        if os.path.exists(residuals_path):
            with open(residuals_path) as f:
                d = json.load(f)
            if d.get("backend") in (None, _backend(backend)):
                resid = {mode: {stage: _value(v) for stage, v in
                                stages.items()}
                         for mode, stages in d.get("residuals", {}).items()}
                src += "+residuals"
        return cls(backend=backend, collectives=rows, residuals=resid,
                   source=src, **over)

    # -- lookups -----------------------------------------------------------
    def gbps(self, verb, kind, size_bytes):
        """Measured wire GB/s for one collective at this payload size —
        log-size interpolation over the calibration rows; the nominal
        constant when nothing matching was measured."""
        rows = sorted((r for r in self.collectives
                       if r.get("verb") == verb and r.get("kind") == kind),
                      key=lambda r: r["size_bytes"])
        if not rows:
            return self.coll_gbps
        if size_bytes <= rows[0]["size_bytes"]:
            return float(rows[0]["gbps"])
        if size_bytes >= rows[-1]["size_bytes"]:
            return float(rows[-1]["gbps"])
        for lo, hi in zip(rows, rows[1:]):
            if lo["size_bytes"] <= size_bytes <= hi["size_bytes"]:
                t = ((math.log(size_bytes) - math.log(lo["size_bytes"]))
                     / (math.log(hi["size_bytes"])
                        - math.log(lo["size_bytes"])))
                return float(lo["gbps"] + t * (hi["gbps"] - lo["gbps"]))
        return self.coll_gbps

    def coll_ms(self, verb, kind, size_bytes):
        if size_bytes <= 0:
            return 0.0
        return size_bytes / (self.gbps(verb, kind, size_bytes) * 1e9) * 1e3

    def residual(self, mode, stage):
        try:
            return float(self.residuals[mode][stage])
        except (KeyError, TypeError, ValueError):
            return 1.0


# --------------------------------------------------------------------------
# model analytics (FLOPs / bytes from the config — no torch needed)
# --------------------------------------------------------------------------

class _CfgView:
    """Attribute view over a LlamaConfig, a dict of its fields, or a
    build_engine_from_spec model dict ({"preset": ..., **fields})."""

    def __init__(self, cfg):
        if isinstance(cfg, dict):
            d = dict(cfg)
            preset = d.pop("preset", None)
            d.pop("seed", None)
            if preset == "tiny":
                from .models.llama import LlamaConfig
                cfg = LlamaConfig.tiny(**d)
            else:
                base = dict(vocab_size=32000, hidden_size=4096,
                            intermediate_size=11008, num_hidden_layers=32,
                            num_attention_heads=32,
                            num_key_value_heads=None,
                            max_position_embeddings=2048,
                            dtype="float32", tie_word_embeddings=False)
                base.update(d)
                if base["num_key_value_heads"] is None:
                    base["num_key_value_heads"] = \
                        base["num_attention_heads"]
                self.__dict__.update(base)
                return
        for k in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_hidden_layers", "num_attention_heads",
                  "num_key_value_heads", "max_position_embeddings",
                  "dtype", "tie_word_embeddings"):
            setattr(self, k, getattr(cfg, k, None))
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.dtype is None:
            self.dtype = "float32"


def _cfg_fields(cfg):
    """Plain-scalar field dict of a LlamaConfig (the 'config' preset
    payload of build_engine_from_spec)."""
    if isinstance(cfg, dict):
        return {k: v for k, v in cfg.items()
                if k not in ("preset", "seed")}
    return dict(vars(cfg))


def model_params(cfg):
    """Analytic parameter count of the LLaMA geometry (matches
    model.parameters() for the untied default)."""
    c = _CfgView(cfg)
    h, ffn, L, V = (c.hidden_size, c.intermediate_size,
                    c.num_hidden_layers, c.vocab_size)
    hd = h // c.num_attention_heads
    kv_out = c.num_key_value_heads * hd
    per_layer = (h * h            # q
                 + 2 * h * kv_out  # k, v
                 + h * h           # o
                 + 2 * h * ffn     # gate, up
                 + ffn * h         # down
                 + 2 * h)          # the two RMSNorm scales
    head = 0 if c.tie_word_embeddings else h * V
    return V * h + L * per_layer + h + head


def decode_weight_bytes(cfg, quant=None, weight_dtype=None):
    """Bytes ONE decode step streams from HBM: every layer's seven
    projections + norms + final norm + lm_head (the embedding is a
    b-row gather, not a table read) — the numerator of the serving
    weight roofline (decode_bench's `_weight_bytes_per_step`)."""
    c = _CfgView(cfg)
    h, ffn, L, V = (c.hidden_size, c.intermediate_size,
                    c.num_hidden_layers, c.vocab_size)
    hd = h // c.num_attention_heads
    kv_out = c.num_key_value_heads * hd
    proj = (2 * h * h + 2 * h * kv_out + 2 * h * ffn + ffn * h)
    wb = _dtype_bytes(weight_dtype or c.dtype)
    if quant == "int8":
        # int8 payload + one f32 scale per output channel
        per_layer = proj + (4 * h + 2 * ffn) * 4  # channel scales
        head = h * V + V * 4
    else:
        per_layer = proj * wb
        head = h * V * wb
    norms = (2 * h * L + h) * 4
    return L * per_layer + head + norms


def kv_pool_bytes(cfg, max_batch, max_len, dtype=None):
    c = _CfgView(cfg)
    hd = c.hidden_size // c.num_attention_heads
    per_tok = 2 * c.num_hidden_layers * c.num_key_value_heads * hd
    return max_batch * max_len * per_tok * _dtype_bytes(dtype or c.dtype)


def _ring_factor(n):
    """Per-rank wire fraction of a ring allreduce (2(n-1)/n)."""
    return 0.0 if n <= 1 else 2.0 * (n - 1) / n


# --------------------------------------------------------------------------
# predictions
# --------------------------------------------------------------------------

def predict_train_step(model_cfg, plan, calib=None, global_batch=8,
                       seq=512, dtype="bfloat16", moment_dtype="float32",
                       hbm_cap_gb=None):
    """Predicted wall-clock of ONE optimizer step under `plan`.

    Terms (ms, in .breakdown):
      compute   - matmul+attention FLOPs / (peak * mfu), per device
      bubble    - pipeline fill/drain idle (gpipe/1f1b fraction)
      dp_sync   - data-axis gradient allreduce (ring volume; int8 wire
                  bytes when plan.grad_compress)
      shard_sync- sharding-axis reduce-scatter + the param gather the
                  stage implies (stage 3 pays gather fwd+bwd)
      mp_coll   - tensor-parallel activation allreduces (4/layer)
      pp_p2p    - pipeline boundary activations
    Deferred sync (grad_accum>1) raises the overlap credit on the
    gradient collectives — the XLA latency-hiding shape
    docs/distributed_perf.md describes.  HBM fit is a hard constraint:
    .fits False marks the plan rejected (search prunes it).
    """
    calib = calib or Calibration.load()
    c = _CfgView(model_cfg)
    p = plan
    n_batch_like = p.dp * p.sharding
    wb = _dtype_bytes(dtype)
    N = model_params(c)
    N_block = N / (p.mp * p.pp)          # params this device computes with
    h, L = c.hidden_size, c.num_hidden_layers

    feasible = True
    notes = []
    if global_batch % n_batch_like:
        feasible = False
        notes.append(f"global_batch {global_batch} not divisible by "
                     f"dp*sharding {n_batch_like}")
    if c.num_attention_heads % p.mp or c.num_key_value_heads % p.mp:
        feasible = False
        notes.append(f"mp {p.mp} does not divide heads")
    if L % (p.pp * p.virtual_pp_degree):
        feasible = False
        notes.append(f"pp*vpp {p.pp * p.virtual_pp_degree} does not "
                     f"divide layers {L}")
    if p.grad_accum > 1 and p.pp > 1:
        feasible = False
        notes.append("grad_accum>1 is the non-pipeline path")

    tokens_local = global_batch * seq / max(1, n_batch_like)

    # --- compute ---------------------------------------------------------
    # 6N per token (fwd 2N + bwd 4N) over the model block this device
    # owns, plus the causal-attention term (12 L h s / 2 per token)
    flops = (6.0 * N_block + 12.0 * (L / p.pp) * h * seq / 2.0 / 2.0) \
        * tokens_local
    t_compute = flops / (calib.peak_flops * calib.mfu) * 1e3

    # --- pipeline bubble --------------------------------------------------
    micro = p.micro_batch_size or max(1, int(global_batch
                                             // n_batch_like) // max(1, p.pp))
    m_batches = max(1, int(global_batch // max(1, n_batch_like))
                    // max(1, micro))
    if p.pp > 1:
        fill = (p.pp - 1) / (m_batches * p.virtual_pp_degree + p.pp - 1)
        t_bubble = t_compute * fill
    else:
        t_bubble = 0.0

    # --- gradient sync ----------------------------------------------------
    grad_bytes = N_block * 4.0          # f32 grads
    kind = "int8" if p.grad_compress == "int8" else "exact"
    wire_scale = 0.27 if kind == "int8" else 1.0  # 1B payload + scales
    t_dp = calib.coll_ms("allreduce", kind,
                         _ring_factor(p.dp) * grad_bytes * wire_scale)
    if p.dp > 1:
        t_dp += 2.0 * calib.coll_lat_ms   # bucketed launches
    t_shard = 0.0
    if p.sharding > 1:
        rs = (p.sharding - 1) / p.sharding * grad_bytes * wire_scale
        t_shard += calib.coll_ms("reducescatter", kind, rs)
        gather = (p.sharding - 1) / p.sharding * N_block * wb
        # stage 1/2: one param all_gather after update; stage 3 gathers
        # on use in fwd AND bwd
        t_shard += calib.coll_ms("allreduce", "exact",
                                 gather * (2 if p.sharding_stage == 3
                                           else 1))
        t_shard += 2.0 * calib.coll_lat_ms
    # overlap credit: collectives hide behind backward compute; the
    # deferred-sync scan (grad_accum>1) hands XLA one dense collective
    # block and earns more
    overlap = 0.5 if p.grad_accum > 1 else 0.25
    t_sync = (t_dp + t_shard) * (1.0 - overlap)
    t_dp_eff = t_dp * (1.0 - overlap)
    t_shard_eff = t_shard * (1.0 - overlap)

    # --- tensor-parallel collectives -------------------------------------
    t_mp = 0.0
    if p.mp > 1:
        act = tokens_local * h * wb
        vol = 4.0 * (L / p.pp) * _ring_factor(p.mp) / 2.0 * act
        # 4 launches per layer (fwd attn+mlp reassembly, mirrored bwd)
        t_mp = (4.0 * (L / p.pp) * calib.coll_lat_ms
                + calib.coll_ms("allreduce", "exact", vol))

    # --- pipeline p2p -----------------------------------------------------
    t_pp = 0.0
    if p.pp > 1:
        vol = 2.0 * m_batches * micro * seq * h * wb * (p.pp - 1) / p.pp
        t_pp = (2.0 * m_batches * calib.coll_lat_ms
                + calib.coll_ms("allreduce", "exact", vol))

    # --- HBM footprint ----------------------------------------------------
    mb = _dtype_bytes(moment_dtype)
    params_gb = N_block * wb / (p.sharding if p.sharding_stage == 3
                                else 1)
    grads_gb = grad_bytes / (p.sharding if p.sharding_stage >= 2 else 1)
    moments_gb = 2 * N_block * mb / (p.sharding if p.sharding_stage >= 1
                                     else 1)
    act_per_layer = tokens_local * h * wb * (2 if p.recompute else 14)
    acts_gb = act_per_layer * (L / p.pp) / max(1, p.grad_accum)
    hbm = (params_gb + grads_gb + moments_gb + acts_gb) / 1e9
    cap = hbm_cap_gb if hbm_cap_gb is not None else calib.hbm_cap_gb
    fits = feasible and hbm <= cap

    r = calib.residual("training", "step")
    breakdown = {"compute": t_compute * r, "bubble": t_bubble * r,
                 "dp_sync": t_dp_eff * r, "shard_sync": t_shard_eff * r,
                 "mp_coll": t_mp * r, "pp_p2p": t_pp * r}
    total = sum(breakdown.values())
    dominant = max(breakdown, key=breakdown.get) if total else "compute"
    tokens_s = (global_batch * seq) / (total / 1e3) if total else 0.0
    return PlanCost(
        total_ms=total, breakdown=breakdown, hbm_gb=hbm, hbm_cap_gb=cap,
        fits=fits, dominant=dominant,
        meta={"tokens_per_sec": tokens_s, "feasible": feasible,
              "notes": notes, "overlap": overlap,
              "sync_raw_ms": t_dp + t_shard,
              "calibration": calib.source})


def predict_serving(model_cfg, spec, calib=None, prompt_len=128,
                    gen_tokens=64, hbm_cap_gb=None):
    """Predicted TTFT / TPOT / HBM for `spec` (one EngineSpec).

    TPOT terms (ms/token, in .breakdown):
      weight_stream - decode weight bytes / tp / HBM bandwidth (the
                      batch<=8 decode roofline)
      flops         - matmul FLOPs at the decode batch
      tp_coll       - per-layer tensor-parallel reassembly (exact mode
                      gathers; psum mode halves the volume, int8
                      compress quarters it)
      host          - per-block host intervention / decode_block
                      (megakernel "layer"/"multi" shrink it — PR 12
                      measured whole-step host_overhead_frac 0.0)
      interference  - prefill chunks stealing decode steps when the
                      fleet is NOT disaggregated; a prefill:decode
                      split removes it but shrinks the decode pool
    TTFT = prompt prefill FLOPs over the prefill pool.
    Objective (total_ms) = TTFT + gen_tokens * TPOT — one request's
    latency through the fleet; fleet tokens/s rides in .meta.
    """
    calib = calib or Calibration.load()
    c = _CfgView(model_cfg)
    s = spec
    replicas = max(1, s.replicas)
    topo = s.topology()
    n_decode = topo["decode"] if topo else replicas
    n_prefill = topo["prefill"] if topo else replicas
    wb = _dtype_bytes(s.weight_dtype or c.dtype)
    on_cpu = calib.backend == "cpu"

    feasible = True
    notes = []
    if c.num_attention_heads % s.tp or c.num_key_value_heads % s.tp:
        feasible = False
        notes.append(f"tp {s.tp} does not divide heads")
    if topo and topo["prefill"] + topo["decode"] != replicas:
        feasible = False
        notes.append("prefill+decode != replicas")

    # --- TPOT -------------------------------------------------------------
    wbytes = decode_weight_bytes(c, quant=s.quant,
                                 weight_dtype=s.weight_dtype) / s.tp
    t_stream = wbytes / (calib.hbm_gbps * 1e9) * 1e3
    N = model_params(c)
    flops = 2.0 * (N / s.tp) * s.max_batch
    t_flops = flops / (calib.peak_flops * calib.mfu) * 1e3
    if on_cpu and s.megakernel not in (False, None):
        # interpret-mode Pallas on CPU is a parity path, not a speed
        # path — price it out so CPU searches keep the op chain
        t_flops *= 30.0
        notes.append("megakernel on cpu = interpret mode (penalized)")
    t_tp = 0.0
    if s.tp > 1:
        h, L = c.hidden_size, c.num_hidden_layers
        per_layer = s.max_batch * h * wb
        scale = {"exact": 1.0, "psum": 0.5}.get(s.tp_mode, 1.0)
        if s.tp_compress == "int8":
            scale *= 0.27
        vol = 2.0 * L * _ring_factor(s.tp) * per_layer * scale
        kind = "int8" if s.tp_compress == "int8" else "exact"
        # alpha-beta: 2 collective LAUNCHES per layer (attn-out +
        # mlp-out reassembly) + the wire volume — at decode batch sizes
        # the launch term dominates, which is why small models stop
        # wanting tp at all
        t_tp = (2.0 * L * calib.coll_lat_ms
                + calib.coll_ms("allreduce", kind, vol))
    host_frac = {False: 1.0, None: 1.0, "layer": 0.6, "multi": 0.05}.get(
        s.megakernel, 1.0)
    t_host = calib.host_block_ms * host_frac / max(1, s.decode_block)
    t_interfere = 0.0
    if not topo:
        # shared engines interleave prefill chunks with decode steps:
        # amortized per generated token at a balanced request mix
        prefill_flops = 2.0 * (N / s.tp) * prompt_len
        t_prefill_tok = prefill_flops / (calib.peak_flops * calib.mfu) \
            * 1e3
        t_interfere = t_prefill_tok / max(1, gen_tokens)
    rt = calib.residual("serving", "tpot")
    tpot = (t_stream + t_flops + t_tp + t_host + t_interfere) * rt

    # --- TTFT -------------------------------------------------------------
    prefill_flops = 2.0 * (N / s.tp) * prompt_len
    t_prefill = prefill_flops / (calib.peak_flops * calib.mfu) * 1e3
    if s.tp > 1:
        t_prefill += 2.0 * c.num_hidden_layers * calib.coll_lat_ms
    # a bigger prefill pool absorbs concurrent arrivals; per-request
    # prefill time itself does not shrink with replicas, the queue does
    queue = t_prefill * (replicas / max(1, n_prefill) - 1.0)
    ttft = (t_prefill + calib.host_block_ms + max(0.0, queue)) \
        * calib.residual("serving", "ttft")

    # --- decode-pool scaling ---------------------------------------------
    # fewer decode engines serve the same offered load: per-request
    # TPOT inflates by replicas/n_decode when disaggregated
    tpot_eff = tpot * (replicas / max(1, n_decode))

    # --- HBM per device ---------------------------------------------------
    hbm = (decode_weight_bytes(c, quant=s.quant,
                               weight_dtype=s.weight_dtype) / s.tp
           + c.vocab_size * c.hidden_size * wb / s.tp   # embedding
           + kv_pool_bytes(c, s.max_batch, s.max_len,
                           dtype=s.weight_dtype or c.dtype) / s.tp) / 1e9
    cap = hbm_cap_gb if hbm_cap_gb is not None else calib.hbm_cap_gb
    fits = feasible and hbm <= cap

    breakdown = {"ttft": ttft,
                 "decode": gen_tokens * (t_stream + t_flops) * rt,
                 "tp_coll": gen_tokens * t_tp * rt,
                 "host": gen_tokens * t_host * rt,
                 "interference": gen_tokens * t_interfere
                 * (replicas / max(1, n_decode)) * rt}
    total = ttft + gen_tokens * tpot_eff
    dominant = max(breakdown, key=breakdown.get) if total else "decode"
    fleet_tok_s = (n_decode * s.max_batch * 1e3 / tpot) if tpot else 0.0
    return PlanCost(
        total_ms=total, breakdown=breakdown, hbm_gb=hbm, hbm_cap_gb=cap,
        fits=fits, dominant=dominant,
        meta={"ttft_ms": ttft, "tpot_ms": tpot_eff,
              "tpot_engine_ms": tpot, "fleet_tokens_per_sec": fleet_tok_s,
              "feasible": feasible, "notes": notes,
              "calibration": calib.source})


# --------------------------------------------------------------------------
# fleet sizing (traffic target -> replica count)
# --------------------------------------------------------------------------

def model_cfg_from_fleet_spec(spec):
    """LlamaConfig from a fleet spec dict's model half — the same
    preset resolution `build_engine_from_spec` uses, minus the
    construction (sizing needs geometry, not weights)."""
    from .models import LlamaConfig
    model = dict((spec.get("model") if isinstance(spec, dict)
                  else spec) or {})
    model.pop("seed", None)
    preset = model.pop("preset", "tiny")
    if preset == "tiny":
        return LlamaConfig.tiny(**model)
    if preset == "config":
        return LlamaConfig(**model)
    raise ValueError(f"unknown model preset {preset!r}")


def spec_from_fleet_dict(spec, replicas=1):
    """EngineSpec view of a `{"model":..., "engine":...}` worker dict
    (the inverse of fleet_spec() as far as pricing needs): known
    EngineSpec fields lift out of the engine kwargs, the rest ride in
    engine_extra."""
    if hasattr(spec, "fleet_spec"):     # already an EngineSpec
        return dataclasses.replace(spec, replicas=int(replicas))
    eng = dict(spec.get("engine") or {})
    fields = {f.name for f in dataclasses.fields(EngineSpec)} - {
        "model", "engine_extra", "replicas", "prefill", "decode"}
    known = {k: eng.pop(k) for k in list(eng) if k in fields}
    return EngineSpec(model=dict(spec.get("model") or {}),
                      replicas=int(replicas), engine_extra=eng, **known)


def size_fleet(spec, qps=1.0, prompt_len=128, gen_tokens=64,
               util=0.7, max_replicas=64, calib=None):
    """Replica count for a traffic target, priced by predict_serving.

    Little's law: offered concurrency = qps x per-request latency;
    each replica holds max_batch concurrent requests, derated to
    `util` so bursts queue instead of shed.  Returns (n, info) where
    info records the prediction feeding the decision — spawn_fleet
    stows it on handle.plan and the autoscale controller reuses the
    same pricing for scale-up decisions.
    """
    cfg = model_cfg_from_fleet_spec(spec)
    one = spec_from_fleet_dict(spec, replicas=1)
    cost = predict_serving(cfg, one, calib=calib,
                           prompt_len=prompt_len, gen_tokens=gen_tokens)
    e2e_s = cost.total_ms / 1e3
    concurrency = float(qps) * e2e_s
    per_rep = max(1, one.max_batch) * float(util)
    n = max(1, min(int(max_replicas),
                   int(math.ceil(concurrency / max(1e-9, per_rep)))))
    info = {"replicas": n, "qps": float(qps),
            "prompt_len": int(prompt_len), "gen_tokens": int(gen_tokens),
            "util": float(util), "concurrency": concurrency,
            "per_replica_concurrency": per_rep,
            "e2e_ms": cost.total_ms,
            "ttft_ms": cost.meta["ttft_ms"],
            "tpot_ms": cost.meta["tpot_ms"],
            "fleet_tokens_per_sec":
                n * cost.meta["fleet_tokens_per_sec"],
            "fits": cost.fits, "hbm_gb": cost.hbm_gb,
            "calibration": cost.meta["calibration"]}
    return n, info


# --------------------------------------------------------------------------
# plan search
# --------------------------------------------------------------------------

def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def _mesh_devices(mesh):
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return max(1, mesh)
    if isinstance(mesh, dict):
        out = 1
        for v in mesh.values():
            out *= int(v)
        return out
    shape = getattr(mesh, "shape", None)   # any object with a shape map
    if shape is not None:
        out = 1
        for v in dict(shape).values():
            out *= int(v)
        return out
    raise TypeError(f"cannot read a device count from "
                    f"{type(mesh).__name__}")


def enumerate_train_plans(model_cfg, n_devices, knobs=None):
    """Every feasible (divisibility-checked) training plan on n
    devices.  knobs overrides the searched option sets."""
    c = _CfgView(model_cfg)
    k = {"grad_compress": (None, "int8"),
         "grad_accum": (1, 4),
         "sharding_stage": (2, 3),
         "recompute": (False,)}
    k.update(knobs or {})
    plans = []
    for mp in _divisors(n_devices):
        if c.num_attention_heads % mp or c.num_key_value_heads % mp:
            continue
        for pp in _divisors(n_devices // mp):
            if c.num_hidden_layers % pp:
                continue
            rest = n_devices // (mp * pp)
            for sh in _divisors(rest):
                dp = rest // sh
                for gc in k["grad_compress"]:
                    for ga in k["grad_accum"]:
                        if ga > 1 and pp > 1:
                            continue
                        for st in k["sharding_stage"]:
                            if sh == 1 and st != k["sharding_stage"][0]:
                                continue  # stage is moot without the axis
                            for rc in k["recompute"]:
                                plans.append(Plan(
                                    dp=dp, mp=mp, pp=pp, sharding=sh,
                                    sharding_stage=st, grad_compress=gc,
                                    grad_accum=ga, recompute=rc))
    return plans


def enumerate_serving_specs(model_cfg, n_devices, base_spec=None,
                            knobs=None, allow_inexact=False):
    """Every feasible serving spec on n devices: tp (divides heads) x
    replicas x prefill:decode split x megakernel x decode_block.
    base_spec carries the non-searched geometry (max_len/page/batch/
    quant/model).

    The megakernel specs ("layer", "multi") are listed where the PORT's
    kernel takes the geometry (`ops.pallas.decode_megakernel.
    megakernel_supported`: d a multiple of 16 and a shared-memory ring
    plan). The reference's gate wants d a multiple of 128, so the lists
    differ where the two gates do: for `LlamaConfig.tiny()` (d 16) the
    port lists megakernel specs and the reference does not; at 7B (d
    128) both do. Without the megakernel specs the lists are equal."""
    c = _CfgView(model_cfg)
    base = base_spec or EngineSpec.from_model_cfg(model_cfg)
    k = {"decode_block": (1, 8),
         "megakernel": (False, "layer", "multi"),
         "tp_mode": ("exact",) + (("psum",) if allow_inexact else ())}
    k.update(knobs or {})
    try:
        from .ops.pallas.decode_megakernel import megakernel_supported
        hd = c.hidden_size // c.num_attention_heads
        mk_ok = megakernel_supported(
            c.num_attention_heads, c.num_key_value_heads, hd,
            c.hidden_size, c.intermediate_size)
    except Exception:
        mk_ok = False
    specs = []
    for tp in _divisors(n_devices):
        if c.num_attention_heads % tp or c.num_key_value_heads % tp:
            continue
        replicas = n_devices // tp
        splits = [(0, 0)]
        if replicas >= 2:
            splits += [(p, replicas - p) for p in range(1, replicas)]
        for (pn, dn) in splits:
            for mk in k["megakernel"]:
                if mk not in (False, None) and not mk_ok:
                    continue
                if mk == "multi" and base.speculate and tp > 1:
                    pass  # composes since PR 12
                modes = k["tp_mode"] if tp > 1 else ("exact",)
                for tpm in modes:
                    if mk not in (False, None) and tpm == "psum":
                        continue  # megakernel+psum is a typed reject
                    for db in k["decode_block"]:
                        specs.append(dataclasses.replace(
                            base, tp=tp, tp_mode=tpm, megakernel=mk,
                            decode_block=db, replicas=replicas,
                            prefill=pn, decode=dn))
    return specs


def brute_force_plans(model_cfg, mesh, mode="training", **kw):
    """Exhaustive enumeration + scoring with NO pruning shortcuts —
    the oracle tests compare search_plan's ranking against."""
    return search_plan(model_cfg, mesh, mode=mode, top_k=None,
                      prune_hbm=False, **kw)


def search_plan(model_cfg, mesh, mode="training", top_k=8, calib=None,
                base_spec=None, knobs=None, allow_inexact=False,
                prune_hbm=True, hbm_cap_gb=None, **workload):
    """Rank the feasible plan space for `model_cfg` on `mesh`.

    mesh: an axis dict (the port's trainer mesh), a device count, or
      any object with a `shape` mapping.
    mode: "training" -> Plan list; "serving" -> EngineSpec list.
    workload: predict_* kwargs (global_batch/seq or prompt_len/
      gen_tokens ...).
    Returns RankedPlan list, ascending predicted cost (total_ms);
    HBM-unfit and infeasible plans are pruned (prune_hbm=False keeps
    them, ranked last — brute_force_plans uses this)."""
    calib = calib or Calibration.load()
    n = _mesh_devices(mesh)
    ranked = []
    if mode == "training":
        for plan in enumerate_train_plans(model_cfg, n, knobs=knobs):
            cost = predict_train_step(model_cfg, plan, calib=calib,
                                      hbm_cap_gb=hbm_cap_gb, **workload)
            if prune_hbm and not cost.fits:
                continue
            ranked.append(RankedPlan(plan=plan, cost=cost))
    elif mode == "serving":
        specs = enumerate_serving_specs(model_cfg, n,
                                        base_spec=base_spec, knobs=knobs,
                                        allow_inexact=allow_inexact)
        for spec in specs:
            cost = predict_serving(model_cfg, spec, calib=calib,
                                   hbm_cap_gb=hbm_cap_gb, **workload)
            if prune_hbm and not cost.fits:
                continue
            ranked.append(RankedPlan(plan=spec, cost=cost))
    else:
        raise ValueError(f"mode must be training/serving, got {mode!r}")
    # deterministic: cost, then the plan's field tuple as tie-break
    ranked.sort(key=lambda r: (r.cost.total_ms if r.cost.fits
                               else float("inf"),
                               0 if r.cost.fits else r.cost.total_ms,
                               str(r.plan)))
    for i, r in enumerate(ranked):
        r.rank = i
    return ranked[:top_k] if top_k else ranked


# --------------------------------------------------------------------------
# the reference-surface class (kept) + planner entry points
# --------------------------------------------------------------------------

class CostModel:
    def __init__(self, calibration=None):
        self._calib = calibration

    @property
    def calibration(self):
        if self._calib is None:
            self._calib = Calibration.load()
        return self._calib

    def profile_measure(self, main_program=None, startup_program=None,
                        device="tpu", fetch_cost_list=("time",)):
        """ref: cost_model.py profile_measure — the measured cost of a
        recorded static Program. It runs the program through the static
        `Executor`, which is not ported yet (ROADMAP A9.3)."""
        raise NotImplementedError(
            "CostModel.profile_measure runs a static Program through the "
            "Executor, which is not ported yet (ROADMAP A9.3)")

    def static_cost_data(self):
        """ref: cost_model.py static_cost_data — the reference ships a
        measured per-op cost table; here the planner's analytic roofline
        and `analyze` are the sources, so the table is empty."""
        return {}

    def get_static_op_time(self, op_name=None, forward=True, dtype="float32"):
        """Per-op time table lookup; returns {} for every op (the planner
        treats missing entries as movement-free)."""
        return {}

    def analyze(self, fn, *example_args):
        """FLOPs of one call of `fn(*example_args)`, counted by
        `torch.utils.flop_counter.FlopCounterMode` (matmuls, convolutions
        and attention; elementwise work counts 0): {"flops": ...}. There is
        no "bytes accessed" count: PyTorch's counter has none."""
        import torch
        from torch.utils.flop_counter import FlopCounterMode
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            fn(*example_args)
        return {"flops": float(counter.get_total_flops())}

    def measure_peak_flops(self, dim=1024, iters=10, dtype="float32"):
        """Achieved matmul FLOPs/s on the card: the counted FLOPs of one
        `torch.matmul` of two [dim, dim] matrices (`analyze`) over its
        time, `iters` calls back to back between two CUDA events — the
        measured `peak_flops * mfu` the roofline divides by. Runs on the
        default device, CUDA. Returns flops/s."""
        import torch
        from . import resolve_device
        dev = resolve_device(None)
        x = torch.ones((dim, dim), dtype=getattr(torch, dtype), device=dev)
        flops = float(self.analyze(torch.matmul, x, x).get(
            "flops", 2.0 * dim ** 3)) or 2.0 * dim ** 3
        y = torch.matmul(x, x)                       # warm (cuBLAS handle)
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            y = torch.matmul(x, x)
        end.record()
        torch.cuda.synchronize(dev)
        dt = start.elapsed_time(end) / 1e3 / max(1, iters)
        return flops / max(dt, 1e-9)

    def predict_train_step(self, model_cfg, plan, **kw):
        kw.setdefault("calib", self.calibration)
        return predict_train_step(model_cfg, plan, **kw)

    def predict_serving(self, model_cfg, spec, **kw):
        kw.setdefault("calib", self.calibration)
        return predict_serving(model_cfg, spec, **kw)

    def search_plan(self, model_cfg, mesh, **kw):
        kw.setdefault("calib", self.calibration)
        return search_plan(model_cfg, mesh, **kw)


# --------------------------------------------------------------------------
# CLI self-test: python -m paddle_tpu_torch.cost_model --check
# --------------------------------------------------------------------------

def _check():
    """Fast planner self-test (wired into tier-1): load calibration,
    search a tiny config in both modes, assert ranked plans come back,
    round-trip the winners through JSON."""
    calib = Calibration.load()
    tiny = {"preset": "tiny"}
    train = search_plan(tiny, 8, mode="training", calib=calib,
                        global_batch=8, seq=64)
    assert train, "training search returned no plans"
    spec0 = EngineSpec(model={"preset": "tiny", "seed": 0}, max_len=64,
                       page_size=16, max_batch=2)
    serve = search_plan(tiny, 4, mode="serving", calib=calib,
                        base_spec=spec0, prompt_len=16, gen_tokens=16)
    assert serve, "serving search returned no plans"
    p = Plan.from_json(train[0].plan.to_json())
    assert p == train[0].plan, "Plan JSON round-trip drifted"
    s = EngineSpec.from_json(serve[0].plan.to_json())
    assert s == serve[0].plan, "EngineSpec JSON round-trip drifted"
    assert serve[0].plan.fleet_spec()["engine"], "empty engine kwargs"
    print(f"cost_model check: OK (calibration={calib.source}, "
          f"backend={calib.backend}, "
          f"{len(train)} training plans [top: {train[0].plan.dp}x"
          f"{train[0].plan.mp}x{train[0].plan.pp}x"
          f"{train[0].plan.sharding} — {train[0].why()}], "
          f"{len(serve)} serving plans [top: tp={serve[0].plan.tp} "
          f"replicas={serve[0].plan.replicas} — {serve[0].why()}])")
    return 0


def _main(argv):
    if "--check" in argv:
        return _check()
    print(__doc__)
    print("usage: python -m paddle_tpu_torch.cost_model --check")
    return 2


if __name__ == "__main__":
    import sys
    sys.exit(_main(sys.argv[1:]))

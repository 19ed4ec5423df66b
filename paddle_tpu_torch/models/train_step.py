"""Single-device training step for LLaMA and GPT: the port of `SpmdTrainer`.

Counterpart of `paddle_tpu/models/train_step.py` on a mesh whose every
axis has size 1 (the configuration `bench.py` `_measure` trains): embed,
the decoder layers (optionally recomputed in backward), the final norm,
then the lm_head and CE fused chunk by chunk (`ops/fused_ce.py`), one
backward, and the reference's AdamW (`_adamw_core`). PyTorch runs eagerly,
so there is no compiled program: `step` runs the model's own modules with
the state's tensors bound to its parameters.

Keys (GPT's dropout): `step(key=)` binds the key with
`framework.random.key_scope` for the step (`key=None` draws one from the
global generator; `grad_accum=K` binds `split(key, K)[i]` for micro-batch
i), as the reference's step does. The reference runs the decoder layers
as one `lax.scan` body traced once, so every layer draws the same
counters (GPT: embedding 1, the attention seed 2, hidden dropout 3, for
every layer). The port rewinds the scope's counter to its value after the
embedding before each layer and before each layer's recompute, and runs
the step under `framework.random.cached_draws()`, so a draw repeated by a
later layer or a recompute reuses the first one's mask instead of hashing
again.

State: {"params": {name: tensor}, "opt": {name: {"m", "v"}}, "step": int},
keyed by the model's parameter names. Parameters live in `param_dtype`
with no f32 master copy (the reference's `_init_params12`); the moments
live in `moment_dtype`, and the update math is f32. `step` updates the
state's tensors in place (the reference donates its state to the step)
and returns the same dict. `gather_params` gives the reference's layout
(outer list + per-name stacked [L, ...] in `phys_order`).

`plan=` (a `cost_model.Plan` or its JSON dict) sets the knobs it carries, as
in the reference, after checking the mesh against `plan.mesh_axes()`.

Tensor parallelism (the "model" axis, ROADMAP A8.5): `SpmdTrainer(model,
mesh={"model": n})` with a model built under `fleet.init(mp_degree=n)`
(its layers the model-parallel ones, `model.mp_degree == n`), one trainer
a rank. Each rank steps its own shards and its copy of the replicated
parameters: the embedding and layers as built, then the fused head and CE
over the rank's vocab shard (`ops/fused_ce.py` over the model-parallel
group, its input through `mp_ops._c_identity`), one backward, AdamW
elementwise. The model-parallel layers leave every rank the dense
gradient of what it holds, so the moments, too, are the dense ones'
slices (the reference needs `_untied_psum("model")(loss / mp)` for that,
`paddle_tpu/models/train_step.py:919-929`). `gather_params` and
`canonical_state` gather the shards over the group into the reference's
layout on every rank. The reference's dropout draws under its `{"model":
n}` shard_map are kept (`models/gpt.py`).

Not ported here: the other mesh axes above 1 — "data" within the
trainer (tensor x data parallelism, the A8.5 remainder), "pipe" (A8.7),
"sharding" (A8.8), "sep" (A8.6, with GPT's position offset) — the
pipeline schedules (A8.7), `grad_compress` (A8.2) and sequence
parallelism (A8.6); each raises NotImplementedError naming its ROADMAP
item. `sharding_stage` only changes the layout of the state across ranks,
so without a sharding axis the three stages are the same step.
"""
import contextlib

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..framework import random as frnd
from ..ops.fused_ce import fused_linear_ce
from ..ops.pallas.flash_attention import AttnResidualStash

_NOT_PORTED = "is not ported yet (ROADMAP A8)"
_AXIS_ITEMS = {"data": "tensor x data parallelism inside the trainer "
                       "(ROADMAP A8.5 remainder)",
               "pipe": "pipeline parallelism (ROADMAP A8.7)",
               "sharding": "ZeRO sharding (ROADMAP A8.8)",
               "sep": "context parallelism and GPT's sep position offset "
                      "(ROADMAP A8.6)"}


def _mesh_shape(mesh):
    """{axis: size} of `mesh`: None, a dict, or any object with a `shape`
    mapping (a JAX mesh's shape, for instance)."""
    if mesh is None:
        return {}
    shape = mesh if isinstance(mesh, dict) else getattr(mesh, "shape", None)
    if not hasattr(shape, "items"):
        raise TypeError(f"mesh must be None, a dict of axis sizes or have a "
                        f"`shape` mapping; got {type(mesh).__name__}")
    return {str(a): int(n) for a, n in shape.items()}


def _model_parts(model):
    """(embed, decoder layers, [final norm, lm_head], token-mean criterion,
    the layers' parameter-name prefix), as the reference's adapters."""
    from .gpt import GPTForCausalLM
    from .llama import LlamaForCausalLM, LlamaPretrainingCriterion
    if isinstance(model, LlamaForCausalLM):
        return (model.llama.embed_tokens, list(model.llama.layers),
                [model.llama.norm, model.lm_head], model.criterion,
                "llama.layers")
    if isinstance(model, GPTForCausalLM):
        return (model.gpt.embeddings, list(model.gpt.h),
                [model.gpt.ln_f, model.lm_head],
                # the token mean of GPT's per-token `ce`
                LlamaPretrainingCriterion(ignore_index=model.ce.ignore_index,
                                          mp_group=model.ce.group),
                "gpt.h")
    raise TypeError(f"unsupported model {type(model).__name__}: the port "
                    f"trains LlamaForCausalLM and GPTForCausalLM")


class SpmdTrainer:
    """`SpmdTrainer(model, mesh=None, ...)` with the reference's
    constructor names and defaults; see the module docstring for what is
    not ported (`micro_batch_size` and `compress_chunk` only matter on the
    paths that are not). `recompute=True` checkpoints each decoder layer:
    `recompute_policy="full"` re-runs the whole layer in backward,
    `"save_attn"` keeps each flash forward's o and lse
    (`AttnResidualStash`) so the recompute does not launch the attention
    kernel again. `fuse_head_ce=True` computes the lm_head and CE in row
    chunks of `ce_chunk`. `matmul_precision` ("highest" or "default";
    default by param dtype as in the reference): "highest" turns TF32 off
    for the step and forms the fused head's logits from f32 operands."""

    def __init__(self, model, mesh=None, lr=1e-3, betas=(0.9, 0.95), eps=1e-8,
                 weight_decay=0.01, micro_batch_size=None, recompute=False,
                 param_dtype=None, sharding_stage=2, pp_schedule="gpipe",
                 virtual_pp_degree=1, fuse_head_ce=True, ce_chunk=4096,
                 matmul_precision=None, recompute_policy="save_attn",
                 moment_dtype="float32", grad_compress=None,
                 compress_chunk=None, grad_accum=1, plan=None):
        # --- declarative plan (cost_model.Plan) -------------------------
        # The planner's output is the single source of truth for the knobs
        # it carries: when plan= is given (a Plan or its JSON dict), its
        # fields REPLACE the corresponding constructor arguments, and then
        # go through the same checks (so a multi-device plan, or int8
        # grad_compress, raises the typed A8 refusal). The mesh must agree
        # with plan.mesh_axes() first.
        self.plan = None
        if plan is not None:
            from ..cost_model import Plan
            if isinstance(plan, dict):
                plan = Plan.from_json(plan)
            mesh_shape = _mesh_shape(mesh)
            for axis, want in plan.mesh_axes().items():
                have = mesh_shape.get(axis, 1)
                if have != want:
                    raise ValueError(
                        f"mesh axis {axis!r} is {have} but the plan "
                        f"needs {want} (plan.mesh_axes()="
                        f"{plan.mesh_axes()}) — build the mesh with "
                        f"plan.build_mesh()")
            self.plan = plan
            sharding_stage = plan.sharding_stage
            grad_compress = plan.grad_compress
            grad_accum = plan.grad_accum
            micro_batch_size = plan.micro_batch_size
            pp_schedule = plan.pp_schedule
            virtual_pp_degree = plan.virtual_pp_degree
            recompute = plan.recompute
        if sharding_stage not in (1, 2, 3):
            raise ValueError(f"sharding_stage must be 1/2/3, got "
                             f"{sharding_stage}")
        if grad_compress not in (None, "int8"):
            raise ValueError(f"grad_compress must be None or 'int8', got "
                             f"{grad_compress!r}")
        if grad_compress is not None:
            raise NotImplementedError(f"grad_compress {_NOT_PORTED}")
        if int(grad_accum) < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if pp_schedule not in ("gpipe", "1f1b", "interleave"):
            raise ValueError(f"pp_schedule must be gpipe/1f1b/interleave, "
                             f"got {pp_schedule}")
        if pp_schedule != "gpipe" or virtual_pp_degree != 1:
            raise NotImplementedError(
                f"pipeline schedules (pp_schedule={pp_schedule!r}, "
                f"virtual_pp_degree={virtual_pp_degree}) {_NOT_PORTED}")
        if recompute_policy not in ("full", "save_attn"):
            raise ValueError(f"recompute_policy must be full/save_attn, got "
                             f"{recompute_policy}")
        shape = _mesh_shape(mesh)
        for axis, n in shape.items():
            if n > 1 and axis != "model":
                what = _AXIS_ITEMS.get(
                    axis, f"multi-device training {_NOT_PORTED}")
                raise NotImplementedError(
                    f"mesh axis {axis!r} of size {n}: {what}")
        if getattr(model.config, "sequence_parallel", False):
            raise NotImplementedError(
                "sequence parallelism is not ported yet (ROADMAP A8.6)")
        self.mp_degree = int(getattr(model, "mp_degree", 1))
        self.mp_group = getattr(model, "mp_group", None)
        if shape.get("model", 1) != self.mp_degree:
            raise ValueError(
                f"mesh axis 'model' is {shape.get('model', 1)} but the "
                f"model's layers split over {self.mp_degree} ranks: build "
                f"the model under fleet.init(mp_degree=n) in a world of n "
                f"and pass mesh={{'model': n}}")

        self.model = model
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.wd = weight_decay
        self.recompute = recompute
        self.sharding_stage = sharding_stage
        self.grad_compress = grad_compress
        self.recompute_policy = recompute_policy
        self.fuse_head_ce = fuse_head_ce
        self.ce_chunk = ce_chunk
        self.grad_accum = int(grad_accum)
        self._pdt = getattr(torch, param_dtype) if isinstance(param_dtype, str) \
            else param_dtype
        self._mdt = getattr(torch, moment_dtype) if isinstance(moment_dtype, str) \
            else moment_dtype
        if matmul_precision is None:
            low = self._pdt in (torch.bfloat16, torch.float16)
            matmul_precision = "default" if low else "highest"
        if matmul_precision not in ("default", "highest"):
            raise ValueError(f"matmul_precision must be default/highest, got "
                             f"{matmul_precision!r}")
        self.matmul_precision = matmul_precision

        embed, decoders, tail, self.criterion, self._layer_prefix = \
            _model_parts(model)
        self.embed, self.decoders, self.tail = embed, decoders, tail
        self.n_layers = len(decoders)
        self.phys_order = list(range(self.n_layers))   # one pipeline stage
        names = {id(p): n for n, p in model.named_parameters()}
        self.outer_names = [names[id(p)] for l in [embed] + tail
                            for p in l.parameters()]
        self.layer_param_names = [n for n, _ in decoders[0].named_parameters()]
        self._params = dict(model.named_parameters())
        self.device = next(model.parameters()).device

    # ---- state --------------------------------------------------------------
    def _cast(self, t):
        if self._pdt is not None and t.is_floating_point():
            return t.to(self._pdt)
        return t

    def init_state(self):
        """Params copied from the model in `param_dtype`, zero moments in
        `moment_dtype`, step 0."""
        with torch.no_grad():
            params = {n: self._cast(p.detach()).clone()
                      for n, p in self._params.items()}
        opt = {n: {"m": torch.zeros(p.shape, dtype=self._mdt, device=p.device),
                   "v": torch.zeros(p.shape, dtype=self._mdt, device=p.device)}
               for n, p in params.items()}
        return {"params": params, "opt": opt, "step": 0}

    def layer_name(self, layer, name):
        return f"{self._layer_prefix}.{layer}.{name}"

    def _whole(self, name, t):
        """`t` (a parameter's or moment's local tensor) whole: the shards
        of every model-parallel rank joined on the parameter's "model"
        dim, in rank order."""
        from ..convert import model_dim
        dim = model_dim(getattr(self._params[name], "dist_attr", None))
        if self.mp_degree == 1 or dim is None:
            return t
        from ..distributed.fleet.meta_parallel.parallel_layers.mp_ops \
            import gather_last
        whole = gather_last(t.movedim(dim, -1).contiguous(), self.mp_group)
        return whole.movedim(-1, dim).contiguous()

    def _layout(self, tensors):
        """{name: tensor} (whole) in the reference's layout."""
        return {"outer": [tensors[n] for n in self.outer_names],
                "stacked": [torch.stack([tensors[self.layer_name(li, n)]
                                         for li in self.phys_order])
                            for n in self.layer_param_names]}

    def gather_params(self, state):
        """The reference's logical layout: {"outer": [embed, final norm,
        lm_head], "stacked": [[L, ...] per decoder parameter name, layers
        in phys_order]}, the shards of a tensor-parallel run gathered
        (a collective: every rank of the group calls it)."""
        p = state["params"]
        return self._layout({n: self._whole(n, t) for n, t in p.items()})

    def canonical_state(self, state):
        """The reference's mesh-independent form: {"params": gather_params,
        "opt": {"outer": [{"m", "v"}], "stacked": [{"m", "v"}]} with each
        moment whole and parameter-shaped (stacked ones [L, ...]), "step"}.
        A collective under tensor parallelism, as `gather_params`."""
        opt = state["opt"]
        moments = {k: self._layout({n: self._whole(n, st[k])
                                    for n, st in opt.items()})
                   for k in ("m", "v")}
        return {"params": self.gather_params(state),
                "opt": {kind: [{"m": m, "v": v} for m, v in
                               zip(moments["m"][kind], moments["v"][kind])]
                        for kind in ("outer", "stacked")},
                "step": state["step"]}

    def sync_to_model(self, state):
        """Write the state's params into the model (copies, in
        `param_dtype`)."""
        with torch.no_grad():
            for n, p in self._params.items():
                p.data = state["params"][n].detach().clone()

    # ---- the step -------------------------------------------------------------
    @contextlib.contextmanager
    def _bound(self, params):
        """The model's Parameters hold the state's tensors (same storage)
        for the duration; their own data and grads come back after."""
        saved = {n: p.data for n, p in self._params.items()}
        try:
            for n, p in self._params.items():
                p.data = params[n]
                p.grad = None
            yield
        finally:
            for n, p in self._params.items():
                p.data = saved[n]
                p.grad = None

    @contextlib.contextmanager
    def _precision(self):
        if self.device.type != "cuda" or self.matmul_precision != "highest":
            yield
            return
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _layer(self, layer, h, box, count):
        """Run one decoder layer (checkpointed under recompute). Each run,
        the recompute included, starts from the scope counter `count`:
        the draws of the reference's one-trace layer body."""
        def rewound(x):
            if box is not None:
                box[1] = count
            return layer(x)

        if not self.recompute:
            return rewound(h)
        if self.recompute_policy == "full":
            return checkpoint(rewound, h, use_reentrant=False,
                              preserve_rng_state=False)
        stash = AttnResidualStash()

        def run(x):
            with stash.region():
                return rewound(x)

        return checkpoint(run, h, use_reentrant=False, preserve_rng_state=False)

    def loss(self, ids, labels):
        """The step's loss on the bound params: token mean over all rows
        (ignored rows add 0), fused head+CE or the model's criterion.
        Inside a `key_scope` every layer draws the counters that follow
        the embedding's (see the module docstring)."""
        embed, (norm, lm_head) = self.embed, self.tail
        h = embed(ids)
        box = frnd.current_scope()
        count = box[1] if box is not None else None
        for layer in self.decoders:
            h = self._layer(layer, h, box, count)
        h = norm(h)
        if not self.fuse_head_ce:
            return self.criterion(lm_head(h), labels)
        flat = h.reshape(-1, h.shape[-1])
        group = None
        if self.mp_degree > 1:
            from ..distributed.fleet.meta_parallel.parallel_layers.mp_ops \
                import _c_identity
            # the column-parallel input: dh sums every vocab shard's part
            group = self.mp_group
            flat = _c_identity(flat, group=group)
        total, _ = fused_linear_ce(
            flat, lm_head.weight, labels.reshape(-1), axis=group,
            chunk=self.ce_chunk, ignore_index=self.criterion.ignore_index,
            precision=self.matmul_precision)
        return total / flat.shape[0]

    def _as_ids(self, x):
        return torch.as_tensor(x).to(device=self.device, dtype=torch.long)

    def step(self, state, ids, labels, key=None, lr=None, grads_out=None):
        """One AdamW step on a batch; returns (state, loss), the loss a
        0-dim f32 tensor on the device (no host read). `key`: the step's
        key (a [2] tensor or array of uint32 words, as
        `framework.random.key` or JAX's `key_data` give), or None for the
        global generator's next. `grads_out`: a dict that receives the
        step's gradients by parameter name (this rank's shards under
        tensor parallelism), for checks."""
        ids, labels = self._as_ids(ids), self._as_ids(labels)
        lr = self.lr if lr is None else float(lr)
        params = state["params"]
        K = self.grad_accum
        if ids.shape[0] % K:
            raise ValueError(f"grad_accum={K} must divide the batch "
                             f"{ids.shape[0]}")
        key = frnd.next_key() if key is None else frnd.as_key(key)
        with self._bound(params), self._precision(), frnd.cached_draws():
            if K == 1:
                with frnd.key_scope(key):
                    loss = self.loss(ids, labels)
                    loss.backward()
                grads = {n: p.grad for n, p in self._params.items()}
            else:
                # each micro-batch's loss and grads are slice means;
                # averaging the K slices (grads summed in f32) gives the
                # full-batch mean, as the reference's scan does
                grads, loss = {}, 0.0
                for ids_k, lab_k, key_k in zip(ids.chunk(K), labels.chunk(K),
                                               frnd.split(key, K)):
                    with frnd.key_scope(key_k):
                        lk = self.loss(ids_k, lab_k)
                        lk.backward()
                    loss = loss + lk.detach()
                    for n, p in self._params.items():
                        g = p.grad.float()
                        grads[n] = grads[n] + g if n in grads else g
                        p.grad = None
                grads = {n: g / K for n, g in grads.items()}
                loss = loss / K
            if grads_out is not None:
                grads_out.update(grads)
            state["step"] += 1
            self._adamw(params, grads, state["opt"], state["step"], lr)
        return state, loss.detach()

    def _adamw(self, params, grads, opt, step, lr):
        """The reference's `_adamw_core`, per parameter, in f32: moments
        m = b1 m + (1 - b1) g and v = b2 v + (1 - b2) g^2 (stored in
        moment_dtype), bias correction from the step counter, and the
        decoupled decay p (1 - lr wd) on every parameter. The scalars are
        rounded to f32 as the reference's f32 step computes them."""
        f32 = np.float32
        b1, b2 = self.b1, self.b2
        lr32 = f32(lr)
        decay = float(f32(1) - lr32 * f32(self.wd))
        t = f32(step)
        bc1 = float(f32(1) - f32(b1) ** t)
        bc2 = float(f32(1) - f32(b2) ** t)
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n].float()
                st = opt[n]
                m = b1 * st["m"].float() + (1 - b1) * g
                v = b2 * st["v"].float() + (1 - b2) * g * g
                mhat = m / bc1
                vhat = v / bc2
                p32 = p.float() * decay - float(lr32) * mhat / (vhat.sqrt() + self.eps)
                p.copy_(p32)
                st["m"].copy_(m)
                st["v"].copy_(v)

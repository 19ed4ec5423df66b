"""Sampling: per-request sampling params, the counter-based key stream, the
shared top-K selection math, the logit-processor chain, and grammar-
constrained decoding.

Counterpart of `paddle_tpu/inference/sampling.py`. The host-only parts
(`SamplingParams`, `stop_hit`, the pattern -> NFA -> DFA -> token automaton
chain) are the reference's, copied. The device math is written in torch
and reproduces JAX's random bits exactly:

  - the key stream (`framework/random.py`) is threefry2x32 with JAX's
    partitionable counter layout
    (`jax_threefry_partitionable=True`, the default): `key(seed)` splits a
    64-bit seed into its high and low 32-bit words, `fold_in(key, n)` hashes
    the counter pair (0, n), `split(key, n)` the pairs (0, i), and
    `random_bits(key, shape)` the 64-bit flat index of every element as
    (hi, lo), keeping bits1 ^ bits2 (truncated for 8-bit draws);
  - `uniform` fills the mantissa of 1.0 with the top bits, subtracts 1 and
    scales to [tiny, 1), `gumbel` is -log(-log(u)) (JAX's mode "low"),
    `categorical` the argmax of logits + Gumbel noise. A bf16 row draws
    8-bit randoms, as `jax.random.uniform` does for a dtype with fewer than
    8 mantissa bits.

Words are held in int64 tensors masked to 32 bits (torch's uint32 lacks the
shifts and adds), on the device of the tensors they come with. Key and
uniform bits equal JAX's exactly; the Gumbel noise differs from XLA's by
the last bit of `log` on some elements, so token ids agree wherever no two
candidates sit within that rounding of each other.

Key stream of the engine: the token at absolute position `pos` of a
request's prompt + generated stream is drawn with
`fold_in(key(seed), pos)` (`fold_keys`). Positions are absolute, so a
request's stream depends only on (seed, position), never on scheduling:
decode_block, megakernel mode and batch composition leave it unchanged.

Top-K fold: the engine selects from the top `sample_k` logits, computed by
the megakernel's in-kernel running top-K ("multi" mode, where the [w, V]
logits never exist) or by `top_k` of the materialized logits (the op chain
and "layer" mode); both give `lax.top_k`'s order, value descending with
ties to the lower id. `top_p` / `min_p` act within that candidate set.

Processor chain (materialized logits only: penalties and grammar masks need
the whole vocab row), in order: repetition / presence / frequency penalties
over the generated tokens, the grammar token mask, then temperature ->
top_k -> top_p -> min_p -> categorical through `select_from_topk`. Stop
sequences are matched on the host.
"""
import numpy as np
import torch

from ..framework.random import (  # noqa: F401  (the key stream, re-exported)
    _M32, fold_in, key, random_bits, split, threefry2x32, uniform)

NEG = -1e30      # the engine's masked-logit value


# ---------------------------------------------------------------------------
# SamplingParams


class SamplingParams:
    """Per-request sampling spec (engine API: `add_request(...,
    sampling=SamplingParams(...))`).

    do_sample=False is greedy (argmax) — the other knobs are ignored.
    `top_k=0` means "all sample_k candidates"; a nonzero top_k must be
    <= the engine's `sample_k`. `stop` is a tuple of token-id tuples
    (the engine works in ids; detokenized string matching belongs to the
    caller). `grammar` is a TokenMaskAutomaton (or None).
    """

    __slots__ = ("do_sample", "temperature", "top_k", "top_p", "min_p",
                 "seed", "repetition_penalty", "presence_penalty",
                 "frequency_penalty", "stop", "grammar")

    def __init__(self, do_sample=False, temperature=1.0, top_k=0,
                 top_p=1.0, min_p=0.0, seed=0, repetition_penalty=1.0,
                 presence_penalty=0.0, frequency_penalty=0.0, stop=(),
                 grammar=None):
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.min_p = float(min_p)
        self.seed = int(seed) & 0xFFFFFFFF
        self.repetition_penalty = float(repetition_penalty)
        self.presence_penalty = float(presence_penalty)
        self.frequency_penalty = float(frequency_penalty)
        self.stop = tuple(tuple(int(t) for t in s) for s in stop)
        self.grammar = grammar
        self.validate()

    def validate(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if not 0.0 <= self.min_p <= 1.0:
            raise ValueError(f"min_p must be in [0, 1], got {self.min_p}")
        if self.repetition_penalty <= 0.0:
            raise ValueError(f"repetition_penalty must be > 0, "
                             f"got {self.repetition_penalty}")
        for s in self.stop:
            if not s:
                raise ValueError("empty stop sequence")

    @property
    def needs_processors(self):
        """True when this request needs the materialized-logits
        processor path (penalties over the full vocab row or a grammar
        mask) rather than the folded top-K fast path."""
        return (self.repetition_penalty != 1.0
                or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0
                or self.grammar is not None)

    def to_spec(self):
        """Serializable dict (the grammar automaton serializes its
        tables: they are small, states x vocab)."""
        spec = {"do_sample": self.do_sample,
                "temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "min_p": self.min_p,
                "seed": self.seed,
                "repetition_penalty": self.repetition_penalty,
                "presence_penalty": self.presence_penalty,
                "frequency_penalty": self.frequency_penalty,
                "stop": [list(s) for s in self.stop]}
        if self.grammar is not None:
            spec["grammar"] = self.grammar.to_spec()
        return spec

    @classmethod
    def from_spec(cls, spec):
        if spec is None:
            return None
        if isinstance(spec, SamplingParams):
            return spec
        spec = dict(spec)
        g = spec.pop("grammar", None)
        return cls(grammar=TokenMaskAutomaton.from_spec(g)
                   if g is not None else None, **spec)

    def __repr__(self):
        if not self.do_sample and not self.needs_processors \
                and not self.stop:
            return "SamplingParams(greedy)"
        return (f"SamplingParams(do_sample={self.do_sample}, "
                f"temperature={self.temperature}, top_k={self.top_k}, "
                f"top_p={self.top_p}, min_p={self.min_p}, "
                f"seed={self.seed})")


GREEDY = SamplingParams()


# ---------------------------------------------------------------------------
# threefry2x32 and JAX's key operations live in `framework/random.py`; a key
# is a [2] tensor (the high word, then the low word).


def fold_keys(seeds, positions):
    """[w] uint32 seeds x [w] absolute positions -> [w, 2] keys:
    key(seed) folded with the position counter. THE key-stream
    definition: every sampling site of the engine derives its keys here."""
    seeds = torch.as_tensor(seeds).to(torch.int64) & _M32
    positions = torch.as_tensor(positions, device=seeds.device)
    base = torch.stack([torch.zeros_like(seeds), seeds], dim=-1)
    return fold_in(base, positions)


def gumbel(keys, shape, dtype=torch.float32):
    """`jax.random.gumbel` (mode "low"): -log(-log(u)), u uniform in
    [tiny, 1) of `dtype`."""
    u = uniform(keys, shape, dtype, minval=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def categorical(keys, logits):
    """`jax.random.categorical(key, logits, axis=-1)`: the argmax of
    logits + Gumbel noise of the logits' shape and dtype. keys [2] with
    logits of any shape (one stream over the whole array), or keys [w, 2]
    with logits [w, n] (one stream per row, as under `jax.vmap`).
    Returns int64 ids."""
    if keys.dim() == 1:
        g = gumbel(keys, logits.shape, logits.dtype)
    else:
        g = gumbel(keys, logits.shape[1:], logits.dtype)
    return torch.argmax(g + logits, dim=-1)


# ---------------------------------------------------------------------------
# the shared selection math


def top_k(x, k):
    """`lax.top_k` over the last axis: the k largest values, ordered value
    descending with ties to the lower index (a stable sort; `torch.topk`
    promises no tie order). Returns (values, int64 indices)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _softmax(x):
    """jax.nn.softmax's arithmetic: exp(x - max) over its sum."""
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def select_from_topk(topv, topi, keys, dos, temp, topk, topp, minp,
                     noise=None):
    """Select one token per row from its top-K survivor set.

    topv [w, K] f32 logits sorted descending (ties: lower vocab id first,
    the order of `top_k` and of the megakernel's running merge), topi
    [w, K] their vocab ids, keys [w, 2] per-row keys (fold_keys), dos [w]
    bool do_sample, temp/topp/minp [w] f32, topk [w] int (0 = all K
    candidates). Returns [w] int64.

    Greedy rows take topi[:, 0], the greedy token itself. Order within a
    row: temperature -> top_k -> top_p -> min_p -> categorical. top_p keeps
    ids whose exclusive cumulative probability is < top_p; min_p keeps
    probs >= min_p * max_prob. noise: the rows' Gumbel noise [w, K] drawn
    ahead with `gumbel(keys, (K,))` (the same bits), else drawn here."""
    K = topv.shape[1]
    pick = selection_scores(topv, keys, temp, topk, topp, minp,
                            noise).argmax(-1)
    sampled = torch.gather(topi, 1, pick.clamp(0, K - 1)[:, None])[:, 0]
    return torch.where(dos.to(topv.device), sampled, topi[:, 0]).long()


def selection_scores(topv, keys, temp, topk, topp, minp, noise=None):
    """The scores whose argmax `select_from_topk` draws: the candidates'
    logits over the temperature, cut by top_k, top_p and min_p (to NEG),
    plus each row's Gumbel noise (`categorical`'s sum). [w, K] f32; the gap
    between a row's two largest is the margin of its draw."""
    K = topv.shape[1]
    dev = topv.device
    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    scaled = topv.float() / torch.clamp(temp.float(), min=1e-6)[:, None]
    j = torch.arange(K, device=dev)[None, :]
    topk = topk.to(dev)[:, None]
    keep_k = torch.where(topk > 0, j < topk, True)
    masked = torch.where(keep_k, scaled, neg)
    probs = _softmax(masked)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < topp.float()[:, None]
    keep_m = probs >= minp.float()[:, None] * probs[:, :1]
    final = torch.where(keep_p & keep_m, masked, neg)
    if noise is None:
        noise = gumbel(keys, (K,), final.dtype)
    return noise + final


def apply_penalties(logits, counts, rep, pres, frq):
    """Repetition / presence / frequency penalties over a materialized
    [w, V] logits row. `counts` [w, V] — occurrences among the request's
    GENERATED tokens. rep multiplies/divides (positive logits divide by
    rep, negative multiply), pres subtracts a flat penalty per seen token,
    frq subtracts per occurrence. rep=1 / pres=0 / frq=0 rows pass through
    bit for bit."""
    dt = logits.dtype
    cf = counts.to(dt)
    seen = (counts > 0).to(dt)
    r = rep[:, None].to(dt)
    pen = torch.where(logits > 0, logits / r, logits * r)
    out = torch.where((r != 1.0) & (seen > 0), pen, logits)
    out = out - frq[:, None].to(dt) * cf
    out = out - pres[:, None].to(dt) * seen
    return out


def stop_hit(out_ids, stop):
    """Host-side stop-sequence tail match: True when the generated ids
    end with any stop sequence. O(len(stop) * max seq len) per token —
    stop sequences are short."""
    if not stop:
        return False
    n = len(out_ids)
    for s in stop:
        m = len(s)
        if m <= n and tuple(out_ids[n - m:]) == s:
            return True
    return False


# ---------------------------------------------------------------------------
# grammar-constrained decoding: pattern -> NFA -> DFA -> token automaton


class _NFA:
    """Thompson NFA under construction: char transitions + epsilon
    edges. Fragments return (start, accepts); the NFA owns state
    allocation so combinators compose freely."""

    def __init__(self):
        self.n = 0
        self.trans = {}     # (state, char) -> set(states)
        self.eps = {}       # state -> set(states)

    def state(self):
        self.n += 1
        return self.n - 1

    def edge(self, s, ch, d):
        self.trans.setdefault((s, ch), set()).add(d)

    def eedge(self, s, d):
        self.eps.setdefault(s, set()).add(d)

    def closure(self, states):
        out = set(states)
        work = list(states)
        while work:
            s = work.pop()
            for d in self.eps.get(s, ()):
                if d not in out:
                    out.add(d)
                    work.append(d)
        return frozenset(out)


class Pat:
    """Tiny regular-pattern combinators for compiling grammars to
    character DFAs: Lit / Chars / Seq / Alt / Star / Plus / Opt.
    Enough to express the JSON-schema subset below; users can
    hand-build patterns for custom grammars."""

    def build(self, nfa):
        """Return (start_state, accept_state_set), adding transitions
        to `nfa` (standard Thompson construction)."""
        raise NotImplementedError

    def __or__(self, other):
        return Alt(self, other)

    def __add__(self, other):
        return Seq(self, other)


def _pat(p):
    return p if isinstance(p, Pat) else Lit(p)


class Lit(Pat):
    def __init__(self, s):
        self.s = str(s)

    def build(self, nfa):
        start = nfa.state()
        cur = start
        for ch in self.s:
            nxt = nfa.state()
            nfa.edge(cur, ch, nxt)
            cur = nxt
        return start, {cur}


class Chars(Pat):
    """One character from a set."""

    def __init__(self, chars):
        self.chars = sorted(set(chars))

    def build(self, nfa):
        start = nfa.state()
        end = nfa.state()
        for ch in self.chars:
            nfa.edge(start, ch, end)
        return start, {end}


class Seq(Pat):
    def __init__(self, *parts):
        self.parts = [_pat(p) for p in parts]

    def build(self, nfa):
        start = nfa.state()
        cur = {start}
        for p in self.parts:
            ps, pa = p.build(nfa)
            for s in cur:
                nfa.eedge(s, ps)
            cur = pa
        return start, cur


class Alt(Pat):
    def __init__(self, *parts):
        self.parts = [_pat(p) for p in parts]

    def build(self, nfa):
        start = nfa.state()
        accepts = set()
        for p in self.parts:
            ps, pa = p.build(nfa)
            nfa.eedge(start, ps)
            accepts |= pa
        return start, accepts


class Star(Pat):
    """Zero or more repetitions."""

    def __init__(self, part):
        self.part = _pat(part)

    def build(self, nfa):
        start = nfa.state()
        ps, pa = self.part.build(nfa)
        nfa.eedge(start, ps)
        for a in pa:
            nfa.eedge(a, ps)
        return start, pa | {start}


class Plus(Pat):
    """One or more repetitions."""

    def __init__(self, part):
        self.part = _pat(part)

    def build(self, nfa):
        ps, pa = self.part.build(nfa)
        for a in pa:
            nfa.eedge(a, ps)
        return ps, pa


class Opt(Pat):
    def __init__(self, part):
        self.part = _pat(part)

    def build(self, nfa):
        ps, pa = self.part.build(nfa)
        return ps, pa | {ps}


class CharDFA:
    """Deterministic char automaton: `step[state][ch] -> state` (missing
    key = dead), `accept` set of accepting state ids. Built from a Pat
    via Thompson construction + epsilon-closure subset construction."""

    def __init__(self, step, accept):
        self.step = step        # list[dict char -> int]
        self.accept = accept    # set[int]

    @classmethod
    def compile(cls, pat):
        nfa = _NFA()
        start, accepts = _pat(pat).build(nfa)
        start_key = nfa.closure({start})
        states = {start_key: 0}
        step = [dict()]
        accept = set()
        work = [start_key]
        while work:
            cur = work.pop()
            ci = states[cur]
            if cur & accepts:
                accept.add(ci)
            moves = {}
            for (src, ch), dsts in nfa.trans.items():
                if src in cur:
                    moves.setdefault(ch, set()).update(dsts)
            for ch, dst in sorted(moves.items()):
                key = nfa.closure(dst)
                if key not in states:
                    states[key] = len(step)
                    step.append(dict())
                    work.append(key)
                step[ci][ch] = states[key]
        return cls(step, accept)

    def run(self, state, text):
        """Advance from `state` over `text`. Returns the end state or
        None (dead)."""
        for ch in text:
            state = self.step[state].get(ch)
            if state is None:
                return None
        return state


DIGITS = "0123456789"


def json_schema_pattern(schema):
    """Compile a JSON-schema SUBSET to a character pattern producing
    exactly the schema's valid compact-JSON texts:

      {"type": "integer"}                  -> -?[0-9]+
      {"type": "boolean"}                  -> true|false
      {"type": "string", "enum": [...]}    -> one of the quoted strings
      {"type": "null"}                     -> null
      {"type": "array", "items": S,
       "minItems": m, "maxItems": M}       -> bounded [S, S, ...]
      {"type": "object", "properties": P,
       "required": [...]}                  -> fixed key order (sorted),
                                              required keys only

    Finite/regular by construction (no unbounded nesting — arrays are
    bounded, objects flatten their fixed keys), which is what makes the
    token-mask automaton small and exact."""
    t = schema.get("type")
    if t == "integer":
        return Seq(Opt("-"), Plus(Chars(DIGITS)))
    if t == "boolean":
        return Alt("true", "false")
    if t == "null":
        return Lit("null")
    if t == "string":
        enum = schema.get("enum")
        if not enum:
            raise ValueError("string schemas need an 'enum' (free-form "
                             "strings are unbounded; this subset stays "
                             "finite)")
        return Alt(*[Lit('"%s"' % e) for e in enum])
    if t == "array":
        items = json_schema_pattern(schema["items"])
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", max(lo, 3)))
        if hi < lo:
            raise ValueError(f"maxItems {hi} < minItems {lo}")
        alts = []
        for n in range(lo, hi + 1):
            if n == 0:
                alts.append(Lit("[]"))
            else:
                inner = [items] * n
                seq = ["["]
                for i, it in enumerate(inner):
                    if i:
                        seq.append(",")
                    seq.append(it)
                seq.append("]")
                alts.append(Seq(*seq))
        return Alt(*alts) if len(alts) > 1 else alts[0]
    if t == "object":
        props = schema.get("properties", {})
        req = schema.get("required", sorted(props))
        seq = ["{"]
        for i, name in enumerate(req):
            if i:
                seq.append(",")
            seq.append('"%s":' % name)
            seq.append(json_schema_pattern(props[name]))
        seq.append("}")
        return Seq(*seq)
    raise ValueError(f"unsupported schema type {t!r}")


class TokenMaskAutomaton:
    """Precompiled token-level grammar automaton: `mask [S, V] bool`
    (token allowed in state) and `table [S, V] i32` (next state). Built
    by lifting a character DFA over a token vocabulary (`token_strs`:
    token id -> its text); a token is allowed iff consuming its text
    from the state stays inside the DFA. `eos_id` is allowed exactly in
    accepting states (and keeps the state — the request retires on EOS
    anyway). State 0 is the start state.

    The engine applies `mask[state]` on-device inside the decode block
    (packed [G, S, V] across the batch's distinct automatons) and the
    HOST advances the authoritative state per emitted token at block
    boundaries, at the decode_block=K rhythm. Dead states
    cannot occur by construction (masked sampling only emits allowed
    tokens), but `advance` clamps defensively."""

    def __init__(self, table, mask, accept_states, eos_id):
        self.table = np.asarray(table, np.int32)
        self.mask = np.asarray(mask, bool)
        self.accept_states = frozenset(int(s) for s in accept_states)
        self.eos_id = int(eos_id)
        assert self.table.shape == self.mask.shape

    @property
    def n_states(self):
        return self.table.shape[0]

    @property
    def vocab(self):
        return self.table.shape[1]

    @classmethod
    def from_pattern(cls, pat, token_strs, eos_id):
        dfa = CharDFA.compile(pat)
        S = len(dfa.step)
        V = len(token_strs)
        table = np.zeros((S, V), np.int32)
        mask = np.zeros((S, V), bool)
        for s in range(S):
            for t, text in enumerate(token_strs):
                if t == eos_id:
                    ok = s in dfa.accept
                    table[s, t] = s
                    mask[s, t] = ok
                    continue
                if not text:
                    continue
                end = dfa.run(s, text)
                if end is not None:
                    table[s, t] = end
                    mask[s, t] = True
        return cls(table, mask, dfa.accept, eos_id)

    @classmethod
    def from_json_schema(cls, schema, token_strs, eos_id):
        return cls.from_pattern(json_schema_pattern(schema), token_strs,
                                eos_id)

    @classmethod
    def trivial(cls, vocab):
        """The always-allow automaton (grammar id 0 in packed batches:
        slots without a grammar ride it as an exact no-op)."""
        return cls(np.zeros((1, vocab), np.int32),
                   np.ones((1, vocab), bool), {0}, vocab - 1)

    def allowed(self, state):
        return self.mask[int(state)]

    def advance(self, state, token):
        s = int(state)
        t = int(token)
        if not (0 <= t < self.vocab) or not self.mask[s, t]:
            return s            # defensive: stay (mask made this
        return int(self.table[s, t])   # unreachable for device picks)

    def accepts(self, state):
        return int(state) in self.accept_states

    def to_spec(self):
        return {"table": self.table.tolist(), "mask": self.mask.tolist(),
                "accept_states": sorted(self.accept_states),
                "eos_id": self.eos_id}

    @classmethod
    def from_spec(cls, spec):
        if isinstance(spec, TokenMaskAutomaton):
            return spec
        return cls(spec["table"], spec["mask"], spec["accept_states"],
                   spec["eos_id"])

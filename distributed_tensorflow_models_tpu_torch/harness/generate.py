"""Autoregressive generation for the LMs: KV-cached decode of the
transformer, carry-threaded decode of the PTB LSTM, and beam search.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/harness/generate.py``.
The prompt runs through the model once (filling the transformer's
``KVCache``, or the LSTM's carry), its last logits give the first token,
and each later token is one step that feeds the previous token: a
static-length loop (the JAX package's ``lax.scan``), so "stop at EOS"
means "freeze at EOS".  Greedy at ``temperature == 0``; otherwise sampling
with optional top-k and nucleus (top-p) filtering, by the Gumbel-max rule
on noise drawn from a generator seeded per token (:func:`key_schedule`).
Every decision goes through :func:`sample_rows`, the one sampler the
serving engine (``serving/engine.py``) also calls, with the knobs as
per-row tensors: a served stream and a solo ``generate`` share its bits
by construction.

On CUDA the one-token step reads and writes only static tensors (the
token, the cache or carry with its index, the EOS flags, the sampled
noise from a registered generator), so it runs as one CUDA graph: the
first step eagerly, then captured once and replayed for every later token
(``captures`` and ``replays`` count them in the process).  Nothing is read
back to the host inside the loop.  On the CPU, or with ``capture=False``,
every step runs eagerly; both give the same tokens bit for bit.  The
decode's products run on kernel R1 (``ops/rowwise.py``; its attention is
``ops/attention.py::rowwise_attention`` over the cache, the JAX package's
reference attention with row-invariant sums), so a row's tokens do not
depend on the batch.  A captured step's R1 launches count once per
replay (:class:`Stepper`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from distributed_tensorflow_models_tpu_torch.core.train_loop import _leaves
from distributed_tensorflow_models_tpu_torch.ops import _kernels

# CUDA-graph captures and replays of a decode step in this process.
captures = 0
replays = 0


def _filter_logits(logits: torch.Tensor, top_k: int,
                   top_p: float) -> torch.Tensor:
    """Top-k and nucleus filtering, static-shaped: entries outside the
    kept set become -inf.

    Top-k alone thresholds at the k-th largest value from ``torch.topk``;
    with a top-p the row is sorted in full.  Both paths threshold the row
    against the same k-th value (ties at it are kept by both), so they give
    the same bits.  ``top_k`` at or above the vocabulary is a no-op; the
    nucleus keeps the smallest prefix of the sorted row whose mass reaches
    ``top_p`` (of the top-k-filtered distribution), and always the top
    entry, so ``top_p <= 0`` is greedy."""
    if top_k <= 0 and top_p >= 1.0:
        return logits
    k = min(top_k, logits.shape[-1]) if top_k > 0 else 0
    if top_p >= 1.0:
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        return logits.masked_fill(logits < kth, -math.inf)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    if top_k > 0:
        kth = sorted_logits[..., k - 1:k]
        logits = logits.masked_fill(logits < kth, -math.inf)
        # The nucleus below sums the top-k-filtered distribution.
        sorted_logits = sorted_logits.masked_fill(sorted_logits < kth,
                                                  -math.inf)
    if top_p < 1.0:
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        keep[..., 0] = True
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, math.inf)
                             ).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, -math.inf)
    return logits


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniform draws ``u`` (clamped away from 0)."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def _sample_row(row, noise, temperature, top_k, top_p) -> torch.Tensor:
    """:func:`sample_rows` on one row: ``[1, V]`` in, ``[1]`` out."""
    greedy = torch.argmax(row, dim=-1)
    if noise is None:
        return greedy
    V = row.shape[-1]
    t = temperature[:, None]
    scaled = row / torch.where(t > 0, t, torch.ones_like(t))
    sorted_ = torch.sort(scaled, dim=-1, descending=True).values
    # The top-k threshold: the k-th largest tempered logit; off (top_k <=
    # 0) it is -inf and masks nothing.
    kth = torch.gather(sorted_, -1, (torch.clamp(top_k, 1, V) - 1)[:, None])
    kth = torch.where(top_k[:, None] > 0, kth, torch.full_like(kth,
                                                               -math.inf))
    filtered = scaled.masked_fill(scaled < kth, -math.inf)
    # The nucleus of the top-k-filtered distribution, always its top entry.
    sorted_m = sorted_.masked_fill(sorted_ < kth, -math.inf)
    probs = torch.softmax(sorted_m, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < top_p[:, None]
    keep[..., 0] = True
    cutoff = torch.where(keep, sorted_m, torch.full_like(sorted_m, math.inf)
                         ).amin(dim=-1, keepdim=True)
    filtered = torch.where(top_p[:, None] < 1.0,
                           filtered.masked_fill(scaled < cutoff, -math.inf),
                           filtered)
    sampled = torch.argmax(filtered + noise, dim=-1)
    return torch.where(temperature > 0, sampled, greedy)


def sample_rows(logits: torch.Tensor, noise: Optional[torch.Tensor],
                temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor) -> torch.Tensor:
    """One sampling decision per row, ``[B, V] -> [B]`` (int64), with the
    knobs as per-row tensors on the logits' device (``temperature`` and
    ``top_p`` f32, ``top_k`` int), each gated by ``torch.where``: the
    argmax of the row where ``temperature <= 0`` (the first maximum, as
    ``jnp.argmax``), else the argmax of the tempered, top-k- then
    nucleus-filtered row plus its Gumbel ``noise`` (:func:`gumbel`); no
    ``noise`` means every row is greedy.  The same decisions as
    :func:`_filter_logits` then the Gumbel-max rule.  Each row is computed
    alone, on ``[1, V]`` slices, so its bits never depend on the rows
    beside it (a scan or an elementwise pass over ``[B, V]`` may take
    another path per position than over ``[1, V]``); the temperature
    divides as a tensor, never as a host scalar (PyTorch multiplies by a
    scalar's reciprocal on CUDA)."""
    logits = logits.float()
    return torch.cat([
        _sample_row(logits[i:i + 1],
                    None if noise is None else noise[i:i + 1],
                    temperature[i:i + 1], top_k[i:i + 1], top_p[i:i + 1])
        for i in range(logits.shape[0])])


def _sample(logits_last: torch.Tensor, generator: Optional[torch.Generator],
            knobs: tuple) -> torch.Tensor:
    """``generate``'s decision ``[B, V] -> [B]``: :func:`sample_rows` on
    ``knobs`` (its per-row ``temperature, top_k, top_p`` tensors), with
    noise ``[B, V]`` drawn from ``generator`` when it samples (at B = 1
    the serving engine's own draw for the token)."""
    noise = None
    if generator is not None:
        noise = gumbel(torch.rand(logits_last.shape, generator=generator,
                                  dtype=torch.float32,
                                  device=logits_last.device))
    return sample_rows(logits_last, noise, *knobs)


def key_schedule(seed: int, max_new_tokens: int) -> list[int]:
    """The per-token seed schedule of a request: seed ``i`` seeds the
    noise of generated token ``i`` (seed 0 samples from the prompt's last
    logits), drawn from a generator seeded with ``seed``.  The one
    derivation a served stream must share with :func:`generate`."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 2**62, (max_new_tokens,), generator=gen,
                         dtype=torch.int64).tolist()


def sampling_knobs(n: int, temperature: float, top_k: int, top_p: float,
                   device) -> tuple:
    """:func:`sample_rows`' per-row knobs for ``n`` rows alike."""
    return (torch.full((n,), float(temperature), dtype=torch.float32,
                       device=device),
            torch.full((n,), int(top_k), dtype=torch.int64, device=device),
            torch.full((n,), float(top_p), dtype=torch.float32,
                       device=device))


class Stepper:
    """Runs ``body()``, which reads and writes only tensors that live as
    long as the loop, once per call.  Eagerly unless ``capture``; with it
    (CUDA only) the first call runs eagerly on a side stream and the body
    is then captured once as a CUDA graph, which every later call replays.
    ``generator`` (the sampling noise's) is re-seeded with the call's seed
    before the body runs or replays, so eager and replayed draws agree.
    The kernels' launch counters (``ops/_kernels.py``) take back what the
    capture added and add it again on every replay.  ``built`` turns true
    at the first call (the program exists: run eagerly, or captured)."""

    def __init__(self, body: Callable[[], None], device: torch.device,
                 generator: Optional[torch.Generator], capture: bool):
        if capture and device.type != "cuda":
            raise ValueError("a captured decode step needs a CUDA device")
        self.body, self.device = body, device
        self.generator, self.capture = generator, capture
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.counts: dict = {}
        self.built = False

    def __call__(self, seed: Optional[int] = None) -> None:
        global captures, replays
        self.built = True
        if self.generator is not None:
            self.generator.manual_seed(seed)
        if not self.capture:
            self.body()
            return
        if self.graph is not None:
            self.graph.replay()
            _kernels.add_launches(self.counts)
            replays += 1
            return
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.body()
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = _kernels.launch_counts()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            self.body()
        self.counts = {key: n - before.get(key, 0)
                       for key, n in _kernels.launch_counts().items()}
        _kernels.add_launches(self.counts, -1)
        self.graph = graph
        captures += 1


def _check_new_tokens(max_new_tokens: int, temperature: float,
                      seed: Optional[int]) -> None:
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if temperature > 0 and seed is None:
        raise ValueError("temperature sampling needs a seed")


def _check_length(t_prompt: int, max_new_tokens: int, max_len: int) -> None:
    if t_prompt + max_new_tokens > max_len:
        raise ValueError(f"prompt {t_prompt} + new {max_new_tokens} exceeds "
                         f"max_len {max_len}")


def _decode_loop(step_logits: Callable[[torch.Tensor], torch.Tensor],
                 first_logits: torch.Tensor, prompt: torch.Tensor,
                 max_new_tokens: int, temperature: float, top_k: int,
                 top_p: float, seed: Optional[int], eos_id: Optional[int],
                 capture: Optional[bool], return_logits: bool):
    """The loop :func:`generate` and :func:`generate_rnn` share:
    ``step_logits(tok [B, 1])`` runs one step of the model on its state
    (in place) and returns the step's last logits ``[B, V]``."""
    device = prompt.device
    capture = device.type == "cuda" if capture is None else capture
    B, n = prompt.shape[0], max_new_tokens
    seeds = key_schedule(seed if seed is not None else 0, n)
    gen = (torch.Generator(device=device) if temperature > 0 else None)
    knobs = sampling_knobs(B, temperature, top_k, top_p, device)

    def sample(logits_last):
        return _sample(logits_last, gen, knobs)

    out = torch.empty(B, n, dtype=prompt.dtype, device=device)
    all_logits = (torch.empty(B, n, first_logits.shape[-1],
                              dtype=first_logits.dtype, device=device)
                  if return_logits else None)
    if gen is not None:
        gen.manual_seed(seeds[0])
    tok = sample(first_logits)  # [B] int64: the step's static input
    done = (tok == eos_id if eos_id is not None
            else torch.zeros(B, dtype=torch.bool, device=device))
    last = first_logits.clone()
    out[:, 0] = tok
    if return_logits:
        all_logits[:, 0] = first_logits

    def body():
        logits = step_logits(tok[:, None])
        nxt = sample(logits)
        if eos_id is not None:
            nxt = nxt.masked_fill(done, eos_id)
            done.logical_or_(nxt == eos_id)
        tok.copy_(nxt)
        last.copy_(logits)

    stepper = Stepper(body, device, gen, capture)
    for i in range(1, n):
        stepper(seeds[i])
        out[:, i] = tok
        if return_logits:
            all_logits[:, i] = last
    tokens = torch.cat([prompt, out], dim=1)
    return (tokens, all_logits) if return_logits else tokens


@torch.no_grad()
def generate(model, prompt: torch.Tensor, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             seed: Optional[int] = None, eos_id: Optional[int] = None,
             capture: Optional[bool] = None, return_logits: bool = False):
    """Continue ``prompt`` ``[B, T]`` (int, dense) by ``max_new_tokens``
    tokens with the transformer LM ``model`` (any ``TransformerLM``: the
    decode runs on its parameters through a fresh ``KVCache``); returns
    ``[B, T + max_new_tokens]`` in the prompt's dtype, and with
    ``return_logits`` also ``[B, max_new_tokens, V]``, the logits each
    token was chosen from.  ``model.max_len`` bounds ``T +
    max_new_tokens``.  Sampling needs ``seed`` (:func:`key_schedule`).
    With ``eos_id`` a row that emitted it emits it to the end.
    ``capture`` (default: on CUDA) runs the step as a captured CUDA
    graph."""
    _check_new_tokens(max_new_tokens, temperature, seed)
    if max_new_tokens == 0:
        return (prompt, prompt.new_empty(prompt.shape[0], 0, 0)
                ) if return_logits else prompt
    _check_length(prompt.shape[1], max_new_tokens, model.max_len)
    cache = model.init_cache(prompt.shape[0], prompt.device)
    logits, _ = model(prompt, cache=cache)

    def step_logits(tok):
        return model(tok, cache=cache)[0][:, -1]

    return _decode_loop(step_logits, logits[:, -1], prompt, max_new_tokens,
                        temperature, top_k, top_p, seed, eos_id, capture,
                        return_logits)


@torch.no_grad()
def generate_rnn(model, prompt: torch.Tensor, max_new_tokens: int, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: Optional[int] = None,
                 capture: Optional[bool] = None,
                 return_logits: bool = False):
    """:func:`generate` for a carry-threaded LM (the PTB LSTM): the carry
    is the cache, written in place after every step.  ``model(tokens,
    carry) -> (logits, carry)`` and ``model.initial_carry(B, device)`` are
    the whole contract."""
    _check_new_tokens(max_new_tokens, temperature, seed)
    if max_new_tokens == 0:
        return (prompt, prompt.new_empty(prompt.shape[0], 0, 0)
                ) if return_logits else prompt
    logits, carry = model(prompt, model.initial_carry(prompt.shape[0],
                                                      prompt.device))

    def step_logits(tok):
        logits, new = model(tok, carry)
        for old, value in zip(_leaves(carry), _leaves(new)):
            old.copy_(value)
        return logits[:, -1]

    return _decode_loop(step_logits, logits[:, -1], prompt, max_new_tokens,
                        temperature, top_k, top_p, seed, None, capture,
                        return_logits)


def _top_k_stable(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest of each row, ties toward
    the lower index (``jax.lax.top_k``'s order; ``torch.topk`` promises
    none)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.no_grad()
def beam_search(model, prompt: torch.Tensor, max_new_tokens: int, *,
                beam_size: int = 4, capture: Optional[bool] = None):
    """Beam search over the KV cache in the flat ``[B*K]`` layout: the
    prompt runs once per row, its cache and last logits repeat K-fold, and
    only beam 0 starts live (the others score -inf), so the first
    expansion draws K distinct continuations and ``K >= V ** steps`` is
    exhaustive.  Each step expands every beam by every token, keeps the K
    best of the row (ties toward the lower flat index), and reorders the
    cache's rows by the survivors' parents in place.  Scores are sums of
    f32 token log-probs; every beam has the same length, so there is no
    length penalty.  Returns ``(tokens [B, T + max_new_tokens], scores
    [B])``, the best beam of each row."""
    B, T = prompt.shape
    K, n = beam_size, max_new_tokens
    if n < 1:
        raise ValueError("beam_search needs max_new_tokens >= 1")
    _check_length(T, n, model.max_len)
    device = prompt.device
    capture = device.type == "cuda" if capture is None else capture
    cache = model.init_cache(B, device)
    logits, _ = model(prompt, cache=cache)
    cache.keys = [t.repeat_interleave(K, dim=0) for t in cache.keys]
    cache.values = [t.repeat_interleave(K, dim=0) for t in cache.values]
    V = logits.shape[-1]
    rows = torch.arange(B, device=device)[:, None] * K
    scores = torch.full((B, K), -math.inf, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    seqs = torch.zeros(B * K, n, dtype=prompt.dtype, device=device)
    tok = torch.empty(B * K, dtype=torch.int64, device=device)
    t_now = torch.zeros(1, dtype=torch.int64, device=device)

    def expand(logp):
        total = scores[:, :, None] + logp.reshape(B, K, V)
        new_scores, flat = _top_k_stable(total.reshape(B, K * V), K)
        src = (rows + flat // V).reshape(B * K)
        new_tok = (flat % V).reshape(B * K)
        cache.reorder(src)
        seqs.copy_(seqs.index_select(0, src))
        seqs.index_copy_(1, t_now, new_tok[:, None].to(seqs.dtype))
        t_now.add_(1)
        scores.copy_(new_scores)
        tok.copy_(new_tok)

    first = torch.log_softmax(logits[:, -1].float(), dim=-1)
    expand(first.repeat_interleave(K, dim=0))

    def body():
        step = model(tok[:, None], cache=cache)[0]
        expand(torch.log_softmax(step[:, 0].float(), dim=-1))

    stepper = Stepper(body, device, None, capture)
    for _ in range(1, n):
        stepper()
    best = torch.argmax(scores, dim=-1)
    best_seq = seqs.reshape(B, K, n)[torch.arange(B, device=device), best]
    best_score = scores[torch.arange(B, device=device), best]
    return torch.cat([prompt, best_seq], dim=1), best_score

"""Paged inference engine: two programs, bit-identical sampling.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/serving/
engine.py``.  Ties the paged KV arena (:mod:`.kv_slots`) and the radix
prefix cache (:mod:`.prefix_cache`) to the transformer's decode path
(``models/transformer_lm.py`` given a ``KVCache``) under two programs
whose shapes never depend on traffic.  On CUDA each program is captured
once as a CUDA graph and replayed (``harness/generate.py::Stepper``); on
the CPU each runs eagerly.  Both read and write static tensors only:
block tables, tokens, starts and last indices, the per-lane index,
per-lane temperature/top-k/top-p, the noise rows and the output tokens.

- **prefill** — ONE batched dispatch for up to ``prefill_lanes``
  requests: each lane gathers its cache view through its block table,
  runs one ``prefill_chunk``-token right-padded chunk of its prompt as a
  ``[lanes, chunk]`` decode forward at the per-lane start, takes the
  logits row at ``last``, samples, and every lane's pages scatter back
  to the pool in one flattened ``index_copy_``.  Lanes beyond the burst
  ride along inert (all-sentinel tables, zero tokens).
- **decode** — ONE batched dispatch for ALL slots over a *persistent
  working set*: one resident contiguous view per slot
  (:func:`.kv_slots.make_views`), advanced in place.  A lane re-adopts
  its view from the pool (:func:`.kv_slots.adopt_lanes`) only on the
  first dispatch after its prefill, eagerly before the replay, so
  steady-state dispatches copy nothing.  Then ``decode_burst`` ``[S, 1]``
  decode forwards, unrolled in the capture, each lane's sample feeding
  straight back as its next input token (the recurrence ``generate()``
  runs); with speculation a second program verifies a ``[S,
  spec_tokens + 1]`` window.  Decode never writes the pool.

Block tables, lengths and noise are DATA; admission, prefix sharing,
copy-on-write, retirement and block recycling only change their values,
so ``compile_counts()`` stays (1, 1), and (1, 2) with speculation.

**Why batching cannot move a bit.**  The JAX engine gets equal bits per
row from XLA.  PyTorch's library products pick kernels by the row count,
so here the decode forward computes every row the same way whatever the
rows around it: every product and every sum of the decode path is
row-invariant (``ops/rowwise.py``, kernel R1 on the card).  So a lane's
logits and the K/V it writes equal what solo ``generate()`` at batch 1
computes for the same positions, whether its prompt came whole, in
chunks, beside other lanes or partly from resident pages.  Each lane's
adopted view is byte-for-byte the ``[1, max_len, ...]`` cache a
dedicated slot would have held, and decode attention reduces over the
full ``max_len`` view with masked probabilities exactly zero, so batch
composition, page size and table layout cannot change a bit.
Right-padding is sound as in the JAX package: garbage K/V written at
padded positions is strictly after every real query position (causally
masked), lands in the lane's own private or sentinel blocks — never in a
shared resident block — and every later read of a real position happens
only after real K/V overwrote it.

**Warm-prefix reuse is exact**: the per-position K/V a prefill writes is
bitwise invariant to how the prompt was chunked (row-invariant products;
each position's projections read only that position's hidden state), so
a resident block holds exactly the bytes the new request's own prefill
would have produced — under the same weights: pages are keyed by the
weight version they were computed under (:meth:`InferenceEngine._matchable`).

**Sampling.**  The engine and ``generate()`` call one sampler,
:func:`~..harness.generate.sample_rows`, with temperature, top-k and
top-p as per-lane tensors.  JAX passes key material as data; the port
passes NOISE as data: for each sampled lane and token the host draws
``torch.rand([1, V])`` on the engine's device from a generator seeded
with that token's :func:`~..harness.generate.key_schedule` seed, the
very draw solo ``generate()`` at batch 1 makes, into a static ``[S, K,
V]`` buffer.  Greedy lanes draw nothing.

**Weight versions.**  A captured graph holds the addresses of the
tensors it was captured with, so both programs read the engine's own
decode model's parameters.  Each live version's tensors stay on the
device, and a dispatch for a version other than the one loaded copies
that version's tensors in first (``copy_``, once per switch).  Captures
stay (1, 1) across install, promote and rollback.

**KV page shipping.**  ``export_slot`` brings a prefilled slot's prompt
pages to the host as numpy (leaves named as the JAX engine names them,
``blocks_<i>/attn/cached_key`` and ``.../cached_value``; bfloat16 pages as
:data:`~.shipping.BF16_BITS`), and ``admit_shipped`` writes shipped pages
into fresh blocks of the pool (``kv_slots.scatter_pages``) and marks the
lane for the same eager adoption a local prefill gets.  Both run eagerly
outside the programs, so shipping never changes ``compile_counts()``.  A
``fleet_cache`` (``shipping.FleetPrefixIndex``) lets admission adopt
pages another prefill replica advertised.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Optional

import numpy as np
import torch

from distributed_tensorflow_models_tpu_torch.harness.generate import (
    Stepper,
    gumbel,
    key_schedule,
    sample_rows,
)
from distributed_tensorflow_models_tpu_torch.models.transformer_lm import (
    KVCache,
)
from distributed_tensorflow_models_tpu_torch.serving import kv_slots
from distributed_tensorflow_models_tpu_torch.serving import shipping as shiplib
from distributed_tensorflow_models_tpu_torch.serving.prefix_cache import (
    RadixPrefixCache,
    prompt_pages,
)
from distributed_tensorflow_models_tpu_torch.telemetry import registry as reglib


def _param_dict(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


class InferenceEngine:
    """The device half of serving: paged pool + the two programs.

    ``model`` is a ``TransformerLM`` (the dense decode stack); the engine
    runs a copy of it in eval mode on ``device`` (the card unless the
    caller asks for the CPU), whose parameters are the boot weights
    (version 0): ``params`` (a ``{name: tensor}`` mapping of the model's
    parameters, or a model) when given, else the model's own.  The
    engine owns the pool, the block allocator, the prefix cache and the
    :class:`~.kv_slots.SlotManager`; the scheduler decides WHICH requests
    get admitted, the engine moves tokens and blocks.

    Admission is two-resource: a decode lane (slot) AND enough free
    blocks for the request's whole reservation, ``ceil((prompt +
    max_new) / kv_page_tokens)`` pages, taken up front (minus whatever
    the prefix cache already holds) so a request can never be stranded
    mid-decode by pool exhaustion — exhaustion is admission
    backpressure, not preemption.
    """

    def __init__(
        self,
        model,
        params=None,
        *,
        device="cuda",
        max_slots: int = 8,
        prefill_chunk: int = 32,
        decode_burst: int = 1,
        prefill_lanes: int = 1,
        kv_page_tokens: Optional[int] = None,
        kv_pool_blocks: Optional[int] = None,
        prefix_cache: bool = True,
        prefix_cache_blocks: Optional[int] = None,
        spec_tokens: int = 0,
        spec_ngram_order: int = 3,
        spec_min_match: int = 1,
        registry: Optional[reglib.MetricsRegistry] = None,
        fleet_cache=None,
    ):
        if decode_burst < 1:
            raise ValueError(
                f"decode_burst must be >= 1, got {decode_burst}"
            )
        if spec_tokens < 0:
            raise ValueError(
                f"spec_tokens must be >= 0, got {spec_tokens}"
            )
        if spec_tokens + 1 > model.max_len:
            raise ValueError(
                f"spec_tokens {spec_tokens} leaves no room for real "
                f"tokens in max_len {model.max_len}"
            )
        if spec_tokens and spec_min_match < 1:
            raise ValueError(
                f"spec_min_match must be >= 1, got {spec_min_match}"
            )
        if spec_tokens and spec_ngram_order < spec_min_match:
            raise ValueError(
                f"spec_ngram_order {spec_ngram_order} must be >= "
                f"spec_min_match {spec_min_match}"
            )
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}"
            )
        if prefill_chunk > model.max_len:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} exceeds model max_len "
                f"{model.max_len}"
            )
        if prefill_lanes < 1:
            raise ValueError(
                f"prefill_lanes must be >= 1, got {prefill_lanes}"
            )
        # Fleet-wide prefix index (shipping.FleetPrefixIndex, or any
        # object with the same chain-digest lookup/advertise surface).
        # A resident prefix on ANY prefill replica serves the whole
        # fleet: admission consults the index for pages the local trie
        # misses (adopting them into the local trie, so the normal
        # match path reuses them), and prefill advertises freshly
        # resident pages.  Requires the local prefix cache — adopted
        # pages live in the trie like any other resident prefix.
        if fleet_cache is not None and not prefix_cache:
            raise ValueError(
                "fleet_cache requires prefix_cache=True (fleet pages "
                "are adopted into the local radix trie)"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceEngine runs on the card by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU"
            )
        # The decode model: the engine's own copy, whose parameters both
        # programs read (a captured graph holds their addresses).
        self._decode_model = copy.deepcopy(model).to(self.device).eval()
        self._decode_model.requires_grad_(False)
        self._live = dict(self._decode_model.named_parameters())
        if params is not None:
            self._check_params(params)
            with torch.no_grad():
                for name, t in _param_dict(params).items():
                    self._live[name].copy_(t)
        # Weight-version ledger (continuous deployment).  ``version`` is
        # the primary weight version (checkpoint step; 0 = boot weights)
        # and ``self.params`` always aliases its tensors.  A canary is a
        # second live version serving a routed traffic slice; every slot
        # is pinned at admission to the version it was routed to and
        # keeps those exact weights until it retires — that pin is what
        # makes an in-flight stream byte-identical to a solo generate()
        # with its admitted weights, no matter when a swap lands.
        # Retired versions are pruned once no slot references them.
        self.version = 0
        self.canary_version: Optional[int] = None
        self._versions: dict = {0: {name: t.detach().clone()
                                    for name, t in self._live.items()}}
        self.params = self._versions[0]
        self._loaded = 0  # the version the decode model's tensors hold
        self._slot_version: dict = {}  # slot -> version pinned at admit
        self._deploy_active = False  # ever canaried: per-version metrics on
        self.max_slots = int(max_slots)
        self.prefill_chunk = int(prefill_chunk)
        self.decode_burst = int(decode_burst)
        self.prefill_lanes = int(prefill_lanes)
        # Speculative decoding (off at 0): spec_tokens is a
        # CONSTRUCTION-TIME constant exactly like decode_burst — the
        # verify window width (spec_tokens + 1) is baked into the second
        # decode program, never derived from traffic (compile_counts).
        self.spec_tokens = int(spec_tokens)
        self.spec_ngram_order = int(spec_ngram_order)
        self.spec_min_match = int(spec_min_match)
        self.max_len = int(model.max_len)
        if kv_page_tokens is None:
            # Largest page that both divides max_len (tables must tile
            # it exactly) and divides prefill_chunk or vice versa —
            # gcd satisfies both and degrades gracefully for any pair.
            kv_page_tokens = math.gcd(self.max_len, self.prefill_chunk)
        if kv_page_tokens < 1 or self.max_len % kv_page_tokens != 0:
            raise ValueError(
                f"kv_page_tokens {kv_page_tokens} must be >= 1 and "
                f"divide max_len {self.max_len}"
            )
        self.kv_page_tokens = int(kv_page_tokens)
        self._page = self.kv_page_tokens
        self._bps = self.max_len // self._page  # table width (blocks/seq)
        if kv_pool_blocks is None:
            # Sentinel + a full max_len reservation per slot: the paged
            # default can admit at least everything the slotted arena
            # could, and the prefix cache only adds headroom on top.
            kv_pool_blocks = self.max_slots * self._bps + 1
        if kv_pool_blocks < self._bps + 1:
            raise ValueError(
                f"kv_pool_blocks {kv_pool_blocks} cannot hold one "
                f"max_len sequence ({self._bps} blocks + sentinel)"
            )
        self.num_blocks = int(kv_pool_blocks)
        self.registry = (registry if registry is not None
                         else reglib.get_registry())
        self._ensure_spec_metrics()
        self.slots = kv_slots.SlotManager(max_slots)
        self.blocks = kv_slots.BlockPool(self.num_blocks)
        self.prefix_cache = (
            RadixPrefixCache(
                self.blocks, self._page, max_blocks=prefix_cache_blocks
            )
            if prefix_cache else None
        )
        self._evictions_seen = 0  # cache.evictions already mirrored
        self.fleet_cache = fleet_cache
        dm = self._decode_model
        self.pool = kv_slots.make_pool(dm, self.num_blocks, self._page,
                                       self.device)
        # Decode working set: one resident contiguous view per slot.
        # _views_fresh[s] marks "the pool holds newer bytes than slot s's
        # view" (set when a prefill completes, cleared when decode adopts
        # the lane).
        self._views = kv_slots.make_views(dm, self.max_slots, self.max_len,
                                          self.device)
        self._views_fresh = np.zeros((self.max_slots,), bool)
        # Host mirrors of per-slot device inputs: block-table rows and
        # true sequence lengths (counters are derived from these on
        # every dispatch — the pool itself holds no positions).
        self._tables = np.zeros((self.max_slots, self._bps), np.int64)
        self._lengths = np.zeros((self.max_slots,), np.int64)
        self._slot_blocks: dict = {}  # slot -> blocks this request holds
        self._slot_cached: dict = {}  # slot -> cached prefix length
        self._vocab = int(dm.head.kernel.shape[1])
        self._noise_gen = torch.Generator(device=self.device)
        self._build_programs()

    def _check_params(self, params) -> None:
        """A weight tree must match the live one name for name, in shape
        and dtype (the JAX deploy gate's aval equality)."""
        new = _param_dict(params)
        if set(new) != set(self._live):
            raise ValueError(
                f"weights differ in names: missing "
                f"{sorted(set(self._live) - set(new))[:4]}, extra "
                f"{sorted(set(new) - set(self._live))[:4]}"
            )
        for name, t in new.items():
            live = self._live[name]
            if tuple(t.shape) != tuple(live.shape) or t.dtype != live.dtype:
                raise ValueError(
                    f"weight {name}: {tuple(t.shape)} {t.dtype} differs "
                    f"from the live {tuple(live.shape)} {live.dtype}"
                )

    # -- the two programs' static tensors ----------------------------------

    def _build_programs(self) -> None:
        dev, V = self.device, self._vocab
        lanes, c, s = self.prefill_lanes, self.prefill_chunk, self.max_slots
        k, w = self.decode_burst, self.spec_tokens + 1

        def ints(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=dev)

        def floats(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        self._pf = {
            "tables": ints(lanes, self._bps), "tokens": ints(lanes, c),
            "start": ints(lanes), "last": ints(lanes),
            "temperature": floats(lanes), "top_k": ints(lanes),
            "top_p": floats(lanes), "noise": floats(lanes, V),
            "index": ints(lanes), "out": ints(lanes),
        }
        self._dc = {
            "lengths": ints(s), "tokens": ints(s), "drafts": ints(s, w - 1),
            "temperature": floats(s), "top_k": ints(s), "top_p": floats(s),
            "noise": floats(s, max(k, w), V), "token": ints(s),
            "out": ints(s, k), "cand": ints(s, w),
        }
        self._views_cache = KVCache(self._views.keys, self._views.values,
                                    ints(s))
        capture = self.device.type == "cuda"
        self._prefill_prog = Stepper(self._prefill_body, self.device, None,
                                     capture)
        self._burst_prog = Stepper(self._burst_body, self.device, None,
                                   capture)
        self._verify_prog = Stepper(self._verify_body, self.device, None,
                                    capture)

    def _prefill_body(self) -> None:
        """One prompt chunk per lane, ``prefill_lanes`` lanes: gather each
        lane's view through its table, a ``[lanes, chunk]`` decode forward
        at the per-lane start, sample each lane's logits row at ``last``,
        scatter every page back (shared and sentinel blocks may repeat
        across lanes, carrying identical resp. unreachable bytes — see
        :mod:`.kv_slots`)."""
        pf, lanes = self._pf, self.prefill_lanes
        view = kv_slots.gather_cache(self.pool, pf["tables"])
        pf["index"].copy_(pf["start"])
        logits, _ = self._decode_model(
            pf["tokens"], cache=KVCache(view.keys, view.values, pf["index"]))
        rows = logits.gather(
            1, pf["last"][:, None, None].expand(lanes, 1, logits.shape[-1])
        )[:, 0]
        pf["out"].copy_(sample_rows(rows, pf["noise"], pf["temperature"],
                                    pf["top_k"], pf["top_p"]))
        kv_slots.scatter_pages(self.pool,
                               kv_slots.cache_pages(view, self._page),
                               pf["tables"].reshape(-1))

    def _burst_body(self) -> None:
        """``decode_burst`` ``[S, 1]`` decode forwards over the resident
        views at the per-lane index, each lane's sample fed back as its
        next input (``generate()``'s recurrence)."""
        dc = self._dc
        cache = self._views_cache
        cache.index.copy_(dc["lengths"])
        dc["token"].copy_(dc["tokens"])
        for j in range(self.decode_burst):
            logits, _ = self._decode_model(dc["token"][:, None], cache=cache)
            nxt = sample_rows(logits[:, -1], dc["noise"][:, j],
                              dc["temperature"], dc["top_k"], dc["top_p"])
            dc["out"][:, j].copy_(nxt)
            dc["token"].copy_(nxt)

    def _verify_body(self) -> None:
        """Speculative verify: one ``[S, spec_tokens + 1]`` decode forward
        over ``[last_token, d_1 .. d_D]`` per lane, every position sampled
        with its own noise row by the same sampler: row ``i`` is the
        token solo decoding would emit next IF the first ``i`` drafts
        matched.  Draft padding (-1) clamps to token 0: those positions'
        samples are never accepted and their K/V lands past the
        rolled-back length, overwritten before any read."""
        dc = self._dc
        cache = self._views_cache
        cache.index.copy_(dc["lengths"])
        window = torch.cat([dc["tokens"][:, None],
                            torch.clamp(dc["drafts"], min=0)], dim=1)
        logits, _ = self._decode_model(window, cache=cache)
        for i in range(window.shape[1]):
            dc["cand"][:, i].copy_(sample_rows(
                logits[:, i], dc["noise"][:, i], dc["temperature"],
                dc["top_k"], dc["top_p"]))

    def _put(self, buf: torch.Tensor, arr) -> None:
        buf.copy_(torch.from_numpy(np.ascontiguousarray(arr)))

    def _draw(self, noise_row: torch.Tensor, seed: int) -> None:
        """The noise solo ``generate()`` at batch 1 draws for the token of
        ``seed``: ``torch.rand([1, V])`` from a generator seeded with it
        on the engine's device, through :func:`gumbel`."""
        self._noise_gen.manual_seed(int(seed))
        u = torch.rand((1, self._vocab), generator=self._noise_gen,
                       dtype=torch.float32, device=self.device)
        noise_row.copy_(gumbel(u)[0])

    def _load_version(self, vid: int) -> None:
        """Copy version ``vid``'s tensors into the decode model's (once
        per switch: both programs read those addresses)."""
        if vid == self._loaded:
            return
        with torch.no_grad():
            for name, t in self._versions[vid].items():
                self._live[name].copy_(t)
        self._loaded = vid

    # -- request bookkeeping helpers --------------------------------------

    def _ensure_spec_metrics(self) -> None:
        """Pre-create the speculation metrics so zero is observable (a
        spec-on engine that never verified still reports the full
        ``serve/spec_*`` set); a spec-off engine creates NONE of them,
        leaving the spec-off registry byte-for-byte unchanged."""
        if not self.spec_tokens:
            return
        self.registry.counter(reglib.SERVE_SPEC_DRAFTED)
        self.registry.counter(reglib.SERVE_SPEC_ACCEPTED)
        self.registry.timer(reglib.SERVE_SPEC_ACCEPTANCE_RATE)
        self.registry.timer(reglib.SERVE_SPEC_TOKENS_PER_DISPATCH)

    def padded_len(self, prompt_len: int) -> int:
        """Positions a cold prompt occupies after right-padded chunking."""
        c = self.prefill_chunk
        return -(-prompt_len // c) * c

    def padded_suffix(self, prompt_len: int, cached_len: int = 0) -> int:
        """Positions the UNCACHED tail of a prompt occupies after
        right-padded chunking from ``cached_len`` — the prefill work a
        warm request actually pays (and what admission budgets)."""
        c = self.prefill_chunk
        return -(-(prompt_len - cached_len) // c) * c

    def check_fits(self, prompt_len: int, max_new_tokens: int) -> None:
        """Admission bound: real tokens AND the cold padded prefill
        footprint must fit in ``max_len`` (a clamped final-chunk write
        would corrupt real positions — module docstring).  Cold is the
        worst case; warm admission only shrinks the footprint
        (:meth:`_usable_cached_len` re-checks at the actual warmth)."""
        if prompt_len < 1:
            raise ValueError("prompt must be non-empty")
        total = prompt_len + max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"prompt {prompt_len} + new {max_new_tokens} exceeds "
                f"max_len {self.max_len}"
            )
        # With speculation on, the verify window (spec_tokens + 1 wide,
        # static) can start as late as position total - 1, so the table
        # needs spec_tokens positions of headroom past the real tokens
        # — otherwise the window's clamped write would slide back over
        # real positions (same hazard as the padded final prefill chunk).
        if self.spec_tokens and total + self.spec_tokens > self.max_len:
            raise ValueError(
                f"prompt {prompt_len} + new {max_new_tokens} + "
                f"spec_tokens {self.spec_tokens} headroom exceeds "
                f"max_len {self.max_len}"
            )
        if self.padded_len(prompt_len) > self.max_len:
            raise ValueError(
                f"padded prompt {self.padded_len(prompt_len)} "
                f"(chunk {self.prefill_chunk}) exceeds max_len "
                f"{self.max_len}"
            )

    def request_keys(self, rng, max_new_tokens: int) -> np.ndarray:
        """Per-token seeds, ``[max_new_tokens]`` int64 — exactly
        ``generate()``'s ``key_schedule`` (the shared helper), so token i
        of this request samples with the noise solo decoding would have
        drawn.  ``rng`` is the int seed ``generate(seed=)`` takes."""
        return np.asarray(key_schedule(int(rng), max_new_tokens), np.int64)

    def zero_keys(self, max_new_tokens: int) -> np.ndarray:
        """Placeholder seeds for greedy requests (they draw no noise)."""
        return np.zeros((max_new_tokens,), np.int64)

    # -- block/prefix admission --------------------------------------------

    def _matchable(self, prompt, version: int = 0) -> list:
        """The prompt's shareable pages: full pages only, and never the
        final page of an exactly-page-aligned prompt — at least one real
        token must prefill so the first sampled token has a logits row
        (partial-page sharing would need a third copy program).

        Pages hold K/V computed under one weight version, so a request may
        reuse only its own version's: under a version other than the boot
        weights (0) the first page's key leads with ``-version`` (tokens
        are never negative, checkpoint steps are positive), which keys
        each version's pages apart in the trie and in the fleet index.
        The JAX engine keys pages by tokens alone and serves a request
        pages another version computed (ROADMAP §3, F9)."""
        pages = prompt_pages(prompt, self._page)
        pages = pages[: (len(prompt) - 1) // self._page]
        if pages and version:
            pages[0] = (-int(version),) + pages[0]
        return pages

    def _usable_cached_len(self, prompt_len: int, depth: int) -> int:
        """Cached tokens actually usable at warmth ``depth`` (matched
        blocks): stepped down page-by-page until the right-padded
        uncached suffix fits ``max_len`` — a warm start must never push
        the final chunk's padded write past the table (terminates at 0,
        which :meth:`check_fits` already guaranteed fits)."""
        cached = min(
            depth * self._page,
            (prompt_len - 1) // self._page * self._page,
        )
        while cached > 0 and (
            cached + self.padded_suffix(prompt_len, cached) > self.max_len
        ):
            cached -= self._page
        return cached

    def peek_prefill_cost(self, prompt) -> int:
        """Padded uncached-suffix length admission WOULD pay for this
        prompt right now, without touching cache state (LRU stamps,
        counters) — the scheduler's budget estimate, over the primary
        version's resident pages."""
        plen = len(prompt)
        depth = (
            self.prefix_cache.peek(self._matchable(prompt, self.version))
            if self.prefix_cache is not None else 0
        )
        return self.padded_suffix(plen, self._usable_cached_len(plen, depth))

    def admit(self, request_id: int, prompt,
              max_new_tokens: int, *,
              version: Optional[int] = None) -> Optional[tuple]:
        """Two-resource admission: claim a slot AND the request's whole
        block reservation, reusing the longest resident prefix.  Returns
        ``(slot, cached_len)`` or None (no slot / not enough blocks even
        after evicting idle residents — backpressure, nothing leaked).

        ``prompt`` must already satisfy :meth:`check_fits` together with
        ``max_new_tokens`` — the caller validated at submit.  The
        reservation covers prompt + max_new rounded up to whole pages,
        so the request can never run out of blocks mid-decode.

        ``version`` pins the slot to a live weight version (the
        scheduler's canary routing decision); None — or a version that
        stopped being live between routing and admission — falls back
        to the primary.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = len(prompt)
        n_pages = -(-(plen + max_new_tokens) // self._page)
        if self.slots.free_count < 1:
            return None
        if version is None or version not in self._versions:
            version = self.version
        matchable = (
            self._matchable(prompt, version)
            if self.prefix_cache is not None else []
        )
        if matchable and self.fleet_cache is not None:
            self._fleet_extend(matchable)
        depth = (
            self.prefix_cache.peek(matchable) if matchable else 0
        )
        cached = self._usable_cached_len(plen, depth)
        keep = cached // self._page
        matched = (
            self.prefix_cache.match(matchable[:keep]) if keep > 0 else []
        )
        if matched:
            # Retain BEFORE any eviction below: an evicted-but-matched
            # block must stay allocated for this request.
            self.blocks.retain(matched)
        need = n_pages - len(matched)
        if need > self.blocks.free_count and self.prefix_cache is not None:
            self.prefix_cache.evict(need - self.blocks.free_count)
            self._sync_eviction_counter()
        fresh = self.blocks.alloc(need)
        if fresh is None:
            if matched:
                self.blocks.release(matched)
            return None
        if matchable:
            hits = len(matched)
            misses = len(matchable) - hits
            if hits:
                self.registry.counter(
                    reglib.SERVE_PREFIX_CACHE_HITS
                ).inc(hits)
            if misses:
                self.registry.counter(
                    reglib.SERVE_PREFIX_CACHE_MISSES
                ).inc(misses)
        blocks = matched + fresh
        slot = self.slots.alloc(request_id)
        row = np.zeros((self._bps,), np.int64)  # padding -> sentinel 0
        row[: len(blocks)] = blocks
        self._tables[slot] = row
        self._lengths[slot] = cached
        self._slot_blocks[slot] = blocks
        self._slot_cached[slot] = cached
        self._slot_version[slot] = version
        return slot, cached

    def release(self, slot: int) -> int:
        """Retire ``slot``: drop the request's block references (pages
        the prefix cache adopted stay resident; the rest go back on the
        free list) and clear its table row.  Returns the request id."""
        request_id = self.slots.free(slot)
        self.blocks.release(self._slot_blocks.pop(slot))
        self._slot_cached.pop(slot, None)
        self._tables[slot] = 0
        self._lengths[slot] = 0
        self._views_fresh[slot] = False
        self._slot_version.pop(slot, None)
        self._prune_versions()
        return request_id

    # -- weight-version hot-swap (continuous deployment) --------------------
    #
    # Every version's tensors stay on the device; the programs read the
    # decode model's own parameters, into which a dispatch copies its
    # version's tensors when another version is loaded.  The check at
    # install keeps names, shapes and dtypes equal, so no swap rebuilds a
    # program: compile_counts() is pinned across every swap.  All
    # mutators run on the scheduler's thread, so a swap can only land
    # between bursts.

    def slot_version(self, slot: int) -> int:
        """The weight version ``slot`` was admitted under."""
        return self._slot_version.get(slot, self.version)

    def params_for(self, version: int):
        return self._versions[version]

    def live_versions(self) -> tuple:
        """Versions some live structure still references (ascending)."""
        return tuple(sorted(self._versions))

    def _prune_versions(self) -> None:
        keep = {self.version}
        if self.canary_version is not None:
            keep.add(self.canary_version)
        keep.update(self._slot_version.values())
        for vid in [v for v in self._versions if v not in keep]:
            del self._versions[vid]

    def install_canary(self, version: int, params) -> None:
        """Stage a candidate as the canary version.  ``params`` (a
        ``{name: tensor}`` mapping of the model's parameters, or a model)
        must match the live weights name for name in shape and dtype;
        its tensors are copied to the engine's device once, and the
        version becomes routable."""
        if version <= self.version:
            raise ValueError(
                f"candidate version {version} is not newer than the "
                f"primary {self.version}"
            )
        if self.canary_version is not None:
            raise ValueError(
                f"canary {self.canary_version} still in flight"
            )
        self._check_params(params)
        self._versions[version] = {
            name: t.detach().to(self.device, copy=True)
            for name, t in _param_dict(params).items()
        }
        self.canary_version = version
        self._deploy_active = True

    def promote_canary(self) -> int:
        """Make the canary the primary; returns the old primary version.
        The old weights stay live until the last slot pinned to them
        retires (release() prunes)."""
        if self.canary_version is None:
            raise ValueError("no canary to promote")
        old = self.version
        self.version = self.canary_version
        self.params = self._versions[self.version]
        self.canary_version = None
        self._prune_versions()
        return old

    def rollback_canary(self) -> None:
        """Withdraw the canary from routing.  Slots already pinned to it
        finish on its weights (the byte-identity contract holds for
        rolled-back traffic too); the tensors are pruned when they
        retire."""
        if self.canary_version is None:
            raise ValueError("no canary to roll back")
        self.canary_version = None
        self._prune_versions()

    # -- KV page shipping (disaggregated prefill/decode) -------------------
    #
    # The wire unit is the pool page: export gathers a finished slot's
    # prompt pages through the SAME gather_cache/cache_pages ops the
    # prefill program uses (so the shipped bytes are exactly what a
    # dedicated slot would hold) and brings them to the host as numpy;
    # import scatters them into the receiving pool at freshly allocated
    # physical blocks with scatter_pages.  Both sides run eagerly outside
    # the captured programs, so the per-role program pins ((1, 0) prefill
    # / (0, 1) decode) come straight from programs built on first use.
    # Only pages below the prompt length ship: positions past it are
    # right-padding garbage that is causally masked on both ends (module
    # docstring), so decode over adopted pages reduces identically to
    # decode over the pages prefill wrote in place.

    def _page_leaves(self, paged: kv_slots.PagedKV) -> dict:
        """``{path: tensor}`` of a pool-shaped :class:`~.kv_slots.PagedKV`
        under the JAX engine's leaf names (``blocks_<i>/attn/cached_key``
        and ``.../cached_value``; the counters are host truth and never
        ship)."""
        out = {}
        for i, (k, v) in enumerate(zip(paged.keys, paged.values)):
            out[f"blocks_{i}/attn/cached_key"] = k
            out[f"blocks_{i}/attn/cached_value"] = v
        return dict(sorted(out.items()))

    @staticmethod
    def _to_host(t: torch.Tensor) -> np.ndarray:
        """A page tensor as host numpy; bfloat16 as its bit patterns in
        :data:`~.shipping.BF16_BITS` (numpy has no bfloat16)."""
        t = t.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(shiplib.BF16_BITS)
        return t.numpy()

    def _from_host(self, arr, path: str) -> torch.Tensor:
        """A shipped leaf as a tensor on the engine's device, in the
        pool's dtype (the wire dtype must be the pool's: no cast)."""
        want = str(self.pool.keys[0].dtype).removeprefix("torch.")
        a = np.asarray(arr)
        got = shiplib.wire_dtype_name(a.dtype)
        if got != want:
            raise ValueError(
                f"shipped leaf {path!r} is {got}; the pool holds {want}"
            )
        a = np.require(a, requirements=("C", "W"))
        if want == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(self.device)

    def _export_prompt_pages(self, slot: int, n_pages: int) -> dict:
        """The first ``n_pages`` of ``slot``'s sequence as host arrays,
        ``{path: [n_pages, page_tokens, ...]}`` — gathered through the
        slot's block table via :func:`~.kv_slots.gather_cache` then
        re-paged via :func:`~.kv_slots.cache_pages`, the exact ops the
        prefill program moves pages with."""
        table = torch.from_numpy(
            np.ascontiguousarray(self._tables[slot][:n_pages])
        ).to(self.device)
        paged = kv_slots.cache_pages(
            kv_slots.gather_cache(self.pool, table), self._page
        )
        return {
            path: self._to_host(leaf)
            for path, leaf in self._page_leaves(paged).items()
        }

    def export_slot(self, slot: int) -> tuple:
        """Export a prefilled slot's KV for shipping: returns
        ``(prompt_len, {path: [n_pages, page_tokens, ...]})`` covering
        ``ceil(prompt_len / page_tokens)`` pages.  Call after
        ``prefill_batch`` set the slot's true length and before
        ``release`` frees its blocks."""
        plen = int(self._lengths[slot])
        if plen < 1:
            raise ValueError(f"slot {slot} has no prefilled tokens")
        n_pages = -(-plen // self._page)
        return plen, self._export_prompt_pages(slot, n_pages)

    def _shipped_pages(self, pages: dict) -> kv_slots.PagedKV:
        """Shipped host pages (``{path: [n, page_tokens, ...]}``) as a
        :class:`~.kv_slots.PagedKV` on the engine's device; raises on a
        missing leaf or a dtype that is not the pool's."""
        names = self._page_leaves(self.pool)
        missing = [p for p in names if p not in pages]
        if missing:
            raise ValueError(
                f"shipped pages missing pool leaf {missing[0]!r}"
            )
        n = len(self.pool.keys)
        return kv_slots.PagedKV(
            [self._from_host(pages[f"blocks_{i}/attn/cached_key"],
                             f"blocks_{i}/attn/cached_key")
             for i in range(n)],
            [self._from_host(pages[f"blocks_{i}/attn/cached_value"],
                             f"blocks_{i}/attn/cached_value")
             for i in range(n)],
        )

    def _scatter_shipped(self, pages: kv_slots.PagedKV, block_ids) -> None:
        """Write shipped pages (:meth:`_shipped_pages`) into the pool at
        physical ``block_ids`` — the import side of the wire, via
        :func:`~.kv_slots.scatter_pages`."""
        indices = torch.as_tensor(
            np.asarray(block_ids, np.int64), device=self.device
        )
        kv_slots.scatter_pages(self.pool, pages, indices)

    def admit_shipped(self, request_id: int, prompt_len: int,
                      max_new_tokens: int, pages: dict):
        """Decode-side admission of a shipped request: claim a slot AND
        the request's FULL fresh reservation (no prefix matching — the
        prompt's KV arrives on the wire), scatter the shipped prompt
        pages in, and mark the lane for view adoption.  Returns the
        slot, or None on backpressure (slots/blocks exhausted — nothing
        leaked, the caller requeues).  The adopted lane then decodes
        byte-identically to one the local prefill program filled: the
        adopted view is the same bytes either way."""
        plen = int(prompt_len)
        if plen < 1:
            raise ValueError("shipped prompt_len must be >= 1")
        n_pages = -(-plen // self._page)
        for path, arr in pages.items():
            if arr.shape[0] != n_pages or arr.shape[1] != self._page:
                raise ValueError(
                    f"shipped leaf {path!r} shape {arr.shape} does not "
                    f"cover {n_pages} pages of {self._page} tokens"
                )
        n_need = -(-(plen + max_new_tokens) // self._page)
        if self.slots.free_count < 1:
            return None
        # Checked and on the device before any block is taken: a bad
        # bundle raises with nothing allocated.
        shipped = self._shipped_pages(pages)
        if n_need > self.blocks.free_count and self.prefix_cache is not None:
            self.prefix_cache.evict(n_need - self.blocks.free_count)
            self._sync_eviction_counter()
        fresh = self.blocks.alloc(n_need)
        if fresh is None:
            return None
        self._scatter_shipped(shipped, fresh[:n_pages])
        slot = self.slots.alloc(request_id)
        row = np.zeros((self._bps,), np.int64)
        row[: len(fresh)] = fresh
        self._tables[slot] = row
        self._lengths[slot] = plen
        self._slot_blocks[slot] = fresh
        self._slot_cached[slot] = 0
        self._views_fresh[slot] = True
        # Shipped requests decode on the primary at adoption time; the
        # pin keeps them there across any later swap (byte-identity).
        self._slot_version[slot] = self.version
        return slot

    def _fleet_extend(self, matchable: list) -> None:
        """Pull pages the local trie misses from the fleet index: adopt
        the longest advertised extension into freshly allocated blocks
        and insert it into the local trie, so the normal match path
        reuses fleet pages exactly like locally prefilled ones.  Counts
        ``serve/fleet_prefix_{hits,misses}`` block-granularly over the
        consulted tail.  Failure to adopt (no block headroom) is a
        miss, never an error."""
        depth = self.prefix_cache.peek(matchable)
        if depth >= len(matchable):
            return
        found = self.fleet_cache.lookup(matchable)
        n_new = len(found) - depth
        misses = len(matchable) - max(depth, len(found))
        if n_new > 0:
            if n_new > self.blocks.free_count:
                self.prefix_cache.evict(n_new - self.blocks.free_count)
                self._sync_eviction_counter()
            fresh = self.blocks.alloc(n_new)
            if fresh is None:
                misses += n_new
                n_new = 0
            else:
                # np.stack keeps no dtype metadata: view the stack as
                # its pages' dtype (BF16_BITS stays bfloat16 on the wire).
                stacked = {
                    path: np.stack(
                        [np.asarray(lv[path]) for lv in found[depth:]]
                    ).view(np.asarray(found[depth][path]).dtype)
                    for path in found[depth]
                }
                self._scatter_shipped(self._shipped_pages(stacked), fresh)
                # Chain blocks for the trie walk: the already-resident
                # prefix keeps its own blocks (insert leaves existing
                # nodes untouched), the extension adopts the fresh
                # ones; our temporary alloc reference is dropped once
                # the cache holds its own.
                chain = (
                    self.prefix_cache.match(matchable[:depth]) + fresh
                )
                self.prefix_cache.insert(matchable[:len(found)], chain)
                self.blocks.release(fresh)
                self._sync_eviction_counter()
        if n_new > 0:
            self.registry.counter(
                reglib.SERVE_FLEET_PREFIX_HITS
            ).inc(n_new)
        if misses > 0:
            self.registry.counter(
                reglib.SERVE_FLEET_PREFIX_MISSES
            ).inc(misses)

    def _fleet_advertise(self, slot: int, pages: list) -> None:
        """Advertise a freshly prefilled prompt's shareable pages to
        the fleet index (publish-if-absent; skipped wholesale when
        every digest is already advertised, so steady-state repeat
        traffic exports nothing)."""
        if not pages or not self.fleet_cache.any_missing(pages):
            return
        stacked = self._export_prompt_pages(slot, len(pages))
        self.fleet_cache.advertise(
            pages,
            [
                {path: arr[i] for path, arr in stacked.items()}
                for i in range(len(pages))
            ],
        )

    def _sync_eviction_counter(self) -> None:
        delta = (
            self.prefix_cache.evictions - self._evictions_seen
            if self.prefix_cache is not None else 0
        )
        if delta:
            self.registry.counter(
                reglib.SERVE_PREFIX_CACHE_EVICTIONS
            ).inc(delta)
            self._evictions_seen = self.prefix_cache.evictions

    # -- pool telemetry -----------------------------------------------------

    @property
    def blocks_free(self) -> int:
        return self.blocks.free_count

    @property
    def blocks_resident(self) -> int:
        return (
            self.prefix_cache.resident_count
            if self.prefix_cache is not None else 0
        )

    def fragmentation(self) -> float:
        """Internal fragmentation of active reservations: the fraction
        of block-granular token capacity reserved by in-flight requests
        that holds no live token yet (0.0 when idle).  High values mean
        ``kv_page_tokens`` is coarse relative to typical lengths."""
        reserved = sum(len(b) for b in self._slot_blocks.values())
        if reserved == 0:
            return 0.0
        live = sum(int(self._lengths[s]) for s in self._slot_blocks)
        return 1.0 - live / (reserved * self._page)

    # -- host-facing ops ---------------------------------------------------

    def prefill(self, slot: int, prompt: np.ndarray, keydata,
                temperature: float, top_k: int, top_p: float) -> int:
        """Run one request's uncached prompt suffix into ``slot``;
        returns the first generated token.  Single-request convenience
        over :meth:`prefill_batch`."""
        return self.prefill_batch(
            [(slot, prompt, keydata, temperature, top_k, top_p)]
        )[slot]

    def prefill_batch(self, items: list) -> dict:
        """Prefill a burst of admitted requests, ``prefill_lanes`` at a
        time per dispatch of the ONE prefill program.  ``items`` is a
        list of ``(slot, prompt, seed0, temperature, top_k, top_p)``
        (``seed0`` = seed 0 of the request's schedule, matching
        ``generate()``'s sampling of the first token from the prompt's
        last logits).  Each lane starts at its admitted cached length —
        resident prefix pages are never re-prefilled.  Lanes with
        shorter suffixes go inert once done (sentinel tables).  After
        the burst completes, every prompt's shareable pages are inserted
        into the prefix cache — never earlier, so a same-burst twin
        cannot match blocks that are still being filled.  Returns
        ``{slot: first_token}``."""
        out = {}
        # Partition by the slots' pinned weight versions: each group
        # dispatches the SAME program with its own weights loaded.
        byver: dict = {}
        for item in items:
            byver.setdefault(self.slot_version(item[0]), []).append(item)
        with self.registry.span(reglib.SERVE_PREFILL):
            for vid in sorted(byver):
                self._prefill_group(vid, byver[vid], out)
        return out

    def _prefill_group(self, vid: int, items: list, out: dict) -> None:
        """Prefill one weight-version's items."""
        lanes, c = self.prefill_lanes, self.prefill_chunk
        pf = self._pf
        self._load_version(vid if vid in self._versions else self.version)
        for g in range(0, len(items), lanes):
            plans = []
            for slot, prompt, kd0, t, k, p in items[g:g + lanes]:
                prompt = np.asarray(prompt, np.int32).reshape(-1)
                lo0 = self._slot_cached.get(slot, 0)
                bounds = [
                    (lo, min(lo + c, len(prompt)))
                    for lo in range(lo0, len(prompt), c)
                ]
                plans.append((slot, prompt, kd0, t, k, p, bounds))
            for w in range(max(len(pl[6]) for pl in plans)):
                tables = np.zeros((lanes, self._bps), np.int64)
                tokens = np.zeros((lanes, c), np.int64)
                starts = np.zeros((lanes,), np.int64)
                temperature = np.zeros((lanes,), np.float32)
                top_k = np.zeros((lanes,), np.int64)
                top_p = np.ones((lanes,), np.float32)
                last = np.zeros((lanes,), np.int64)
                for i, (slot, prompt, kd0, t, k, p, bounds) in (
                    enumerate(plans)
                ):
                    if w >= len(bounds):
                        continue  # inert lane
                    lo, hi = bounds[w]
                    tables[i] = self._tables[slot]
                    tokens[i, : hi - lo] = prompt[lo:hi]
                    starts[i] = lo
                    temperature[i] = t
                    top_k[i] = k
                    top_p[i] = p
                    last[i] = hi - lo - 1
                    if t > 0 and w == len(bounds) - 1:
                        self._draw(pf["noise"][i], int(np.asarray(kd0)))
                for key, arr in (("tables", tables), ("tokens", tokens),
                                 ("start", starts), ("last", last),
                                 ("temperature", temperature),
                                 ("top_k", top_k), ("top_p", top_p)):
                    self._put(pf[key], arr)
                self._prefill_prog()
                toks = pf["out"].cpu().numpy()
                for i, (slot, *_rest, bounds) in enumerate(plans):
                    if w == len(bounds) - 1:
                        out[slot] = int(toks[i])
            for slot, prompt, *_rest in plans:
                self._lengths[slot] = len(prompt)
                self._views_fresh[slot] = True
                if self.prefix_cache is not None:
                    pages = self._matchable(prompt, self.slot_version(slot))
                    if pages:
                        self.prefix_cache.insert(
                            pages,
                            [int(b) for b in
                             self._tables[slot][:len(pages)]],
                        )
                        self._sync_eviction_counter()
                        if self.fleet_cache is not None:
                            self._fleet_advertise(slot, pages)

    def decode_step(self, lanes: dict) -> dict:
        """One batched decode dispatch.  ``lanes`` maps slot ->
        ``(last_token, seed_rows, temperature, top_k, top_p)`` — or,
        with speculation on, the same plus a sixth ``draft_row``
        element (``[spec_tokens]`` int32, -1 = no proposal; see
        :mod:`.drafter`) — for every ACTIVE slot.  ``seed_rows`` is the
        lane's remaining seed schedule up to the dispatch width (a lane
        with fewer tokens left passes only what remains; its tail
        samples garbage the caller must discard — such a lane finishes
        inside this dispatch, so its slot is retired and the overrun
        never reaches a live request).

        Routing is host-side and data-driven: when ``spec_tokens > 0``
        AND at least one lane proposed a draft token, the dispatch is a
        speculative VERIFY (each lane emits its accepted draft prefix
        plus the target's own correction token — between 1 and
        ``spec_tokens + 1`` tokens — and its length rolls back over the
        rejected tail via :func:`~.kv_slots.rollback_length`); otherwise
        it is the plain ``decode_burst``-token burst.  Returns ``{slot:
        [token, ...]}``.  Inactive slots run as inert lanes — the program
        shape never depends on how many requests are live.

        With a canary in flight, lanes pinned to different weight
        versions split into per-version dispatches of the SAME program.
        Lanes outside the dispatching version ride along as riders: real
        length so their garbage writes land at positions at or past their
        write head (overwritten by their own version's dispatch before
        any read), outputs discarded, host lengths untouched."""
        byver: dict = {}
        for slot in lanes:
            byver.setdefault(self.slot_version(slot), []).append(slot)
        out: dict = {}
        for vid in sorted(byver):
            group = {s: lanes[s] for s in byver[vid]}
            extra = tuple(s for s in lanes if s not in group)
            verify = False
            if self.spec_tokens:
                for lane in group.values():
                    if len(lane) > 5 and lane[5] is not None and (
                        np.asarray(lane[5]) >= 0
                    ).any():
                        verify = True
                        break
            if verify:
                out.update(self._verify_dispatch(group, vid, extra))
            else:
                out.update(self._burst_dispatch(group, vid, extra))
        return out

    def _stage_lanes(self, lanes: dict, width: int, extra_slots: tuple,
                     drafts: Optional[np.ndarray] = None) -> list:
        """Fill the decode program's inputs for ``lanes`` (and riders
        ``extra_slots``) and draw each sampled lane's noise for its next
        ``width`` tokens; adopt fresh lanes.  Returns the adopted slots."""
        s, dc = self.max_slots, self._dc
        lengths = np.zeros((s,), np.int64)
        tokens = np.zeros((s,), np.int64)
        temperature = np.zeros((s,), np.float32)
        top_k = np.zeros((s,), np.int64)
        top_p = np.ones((s,), np.float32)
        refresh = []
        for slot, lane in lanes.items():
            tok, kd, t, tk, p = lane[:5]
            lengths[slot] = self._lengths[slot]
            tokens[slot] = tok
            temperature[slot] = t
            top_k[slot] = tk
            top_p[slot] = p
            if t > 0:
                seeds = np.asarray(kd, np.int64).reshape(-1)[:width]
                for j, seed in enumerate(seeds):
                    self._draw(dc["noise"][slot, j], int(seed))
            # Adopt only lanes whose pool bytes are newer than their
            # view AND that are on this dispatch (a fresh slot not
            # decoded yet keeps its flag for later).
            if self._views_fresh[slot]:
                refresh.append(slot)
        for slot in extra_slots:
            # Rider lanes (pinned to another weight version): real length
            # keeps their garbage writes at or past the write head; no
            # refresh (re-adopting a decoded lane from the pool would
            # destroy its decoded-suffix K/V).
            lengths[slot] = self._lengths[slot]
        kv_slots.set_counters(dc["lengths"], lengths)
        for key, arr in (("tokens", tokens), ("temperature", temperature),
                         ("top_k", top_k), ("top_p", top_p)):
            self._put(dc[key], arr)
        if drafts is not None:
            self._put(dc["drafts"], drafts)
        kv_slots.adopt_lanes(self._views, self.pool, self._tables, refresh)
        return refresh

    def _burst_dispatch(
        self, lanes: dict, vid: Optional[int] = None,
        extra_slots: tuple = (),
    ) -> dict:
        k = self.decode_burst
        self._load_version(
            vid if vid is not None and vid in self._versions
            else self.version)
        # Explicit timing, not registry.span: the dispatch loop stays
        # free of contextmanager enters/exits, and the trace event gets
        # dispatch-kind args the generic span can't carry.
        t0 = time.perf_counter()
        refresh = self._stage_lanes(lanes, k, extra_slots)
        self._burst_prog()
        nxt = self._dc["out"].cpu().numpy()  # [S, K]
        dt = time.perf_counter() - t0
        self.registry.timer(reglib.SERVE_DECODE).record(dt)
        if self.registry.trace.enabled:
            self.registry.trace.complete(
                reglib.SERVE_DECODE, dt, ts_mono=t0,
                args={"kind": "burst", "lanes": len(lanes), "width": k},
            )
        self._views_fresh[refresh] = False
        for slot in lanes:
            self._lengths[slot] += k
        return {
            slot: [int(nxt[slot, i]) for i in range(k)] for slot in lanes
        }

    def _verify_dispatch(
        self, lanes: dict, vid: Optional[int] = None,
        extra_slots: tuple = (),
    ) -> dict:
        """Speculative verify: one width-``spec_tokens+1`` forward per
        lane through the verify program, then host-side accepted-prefix
        truncation + length rollback.  A lane's emitted tokens are ALL
        target samples (the accepted candidates equal the matched drafts
        by the accept rule; the final token is the target's correction)
        — drafts steer which positions get verified, never what is
        emitted, which is why byte-identity to solo ``generate()`` holds
        at any acceptance rate."""
        s, spec = self.max_slots, self.spec_tokens
        w = spec + 1
        drafts = np.full((s, spec), -1, np.int64)
        for slot, lane in lanes.items():
            if len(lane) > 5 and lane[5] is not None:
                dr = np.asarray(lane[5], np.int64).reshape(-1)[:spec]
                drafts[slot, : dr.shape[0]] = dr
        self._load_version(
            vid if vid is not None and vid in self._versions
            else self.version)
        t0 = time.perf_counter()
        refresh = self._stage_lanes(lanes, w, extra_slots, drafts)
        self._verify_prog()
        cand = self._dc["cand"].cpu().numpy()  # [S, W]
        dt = time.perf_counter() - t0
        self.registry.timer(reglib.SERVE_DECODE).record(dt)
        if self.registry.trace.enabled:
            self.registry.trace.complete(
                reglib.SERVE_DECODE, dt, ts_mono=t0,
                args={"kind": "verify", "lanes": len(lanes), "width": w},
            )
        self._views_fresh[refresh] = False
        out: dict = {}
        drafted = accepted = emitted = 0
        for slot in lanes:
            row = cand[slot]
            dvec = drafts[slot]
            # Accept rule: draft i is accepted iff the target's own
            # sample at its position equals it; emit the accepted
            # prefix plus the first mismatch's target sample.
            m = 1
            while m <= spec and dvec[m - 1] >= 0 and (
                int(dvec[m - 1]) == int(row[m - 1])
            ):
                m += 1
            drafted += int((dvec >= 0).sum())
            accepted += m - 1
            emitted += m
            self._lengths[slot] = kv_slots.rollback_length(
                int(self._lengths[slot]), w, m
            )
            out[slot] = [int(row[i]) for i in range(m)]
        self.registry.counter(reglib.SERVE_SPEC_DRAFTED).inc(drafted)
        self.registry.counter(reglib.SERVE_SPEC_ACCEPTED).inc(accepted)
        if drafted:
            self.registry.timer(reglib.SERVE_SPEC_ACCEPTANCE_RATE).record(
                accepted / drafted
            )
            if self._deploy_active and vid is not None:
                # Per-version acceptance split (dispatches are already
                # version-partitioned, so the group rate IS the
                # version's rate).
                self.registry.timer(
                    f"{reglib.SERVE_VERSION_ACCEPTANCE}/{vid}"
                ).record(accepted / drafted)
        self.registry.timer(
            reglib.SERVE_SPEC_TOKENS_PER_DISPATCH
        ).record(emitted / len(lanes))
        return out

    def fsck(self) -> list:
        """Fsck-style arena audit (:func:`~.kv_slots.check_arena`)
        over the live slot tables, rolled-back lengths, block
        ownership, and the prefix trie's residency ledger; returns
        violation strings (empty = consistent)."""
        return kv_slots.check_arena(
            self.blocks, self._tables, self._lengths, self._slot_blocks,
            self._page,
            resident_blocks=(
                self.prefix_cache.resident_blocks()
                if self.prefix_cache is not None else ()
            ),
        )

    def compile_counts(self) -> tuple[int, int]:
        """(prefill, decode) program counts — the shape-stability
        invariant tests pin: the programs built so far (captured on
        CUDA, run on the CPU).  With ``spec_tokens == 0`` the pin is
        ``(1, 1)``.  With speculation on, the verify body is a SECOND
        decode program, so a spec-on engine steady-states at ``(1, 2)``:
        one extra program per engine lifetime, fixed at construction
        like ``decode_burst``, never a per-traffic rebuild."""
        return (
            int(self._prefill_prog.built),
            int(self._burst_prog.built) + int(self._verify_prog.built),
        )

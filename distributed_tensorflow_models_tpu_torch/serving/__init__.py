"""Continuous-batching LM inference: the serving path.

PyTorch counterpart of ``distributed_tensorflow_models_tpu/serving``.  The
training side already decodes with a KV cache (``harness/generate.py``: one
captured step, static shapes, the cache updated in place), but one request
at a time.  Serving traffic is many requests of different lengths arriving
at different times, and running them serially wastes the card: every
decode step streams the whole parameter set from memory to produce ONE
token.  This package implements Orca-style continuous batching
(iteration-level scheduling) over a paged KV cache, PagedAttention's block
pool, so B in-flight requests share one batched decode dispatch per token
and the weight stream amortizes B-fold.

Layering (scheduler -> engine -> kv_slots; strictly one-way):

- :mod:`kv_slots` — the paged arena: a block pool of fixed-size pages,
  block tables as data, and a slot manager over the decode lanes.
  Alloc/free are host-side bookkeeping; every device tensor of the arena
  has a static shape, so the whole serving path builds exactly TWO
  programs (one prefill, one decode) regardless of traffic.
- :mod:`prefix_cache` — the radix trie of resident prompt pages.
- :mod:`drafter` — the n-gram self-drafter of speculative decoding.
- :mod:`engine` — ties the arena to the transformer's decode path.
  Chunked right-padded prefill, one batched decode dispatch over all
  slots, and the one sampler ``generate()`` also calls, so batching NEVER
  changes a request's token stream: the decode path's arithmetic does
  not depend on the row count (``ops/rowwise.py``).
- :mod:`scheduler` — the admission/continuous-batching loop: pack
  waiting prompts into free slots each iteration (bounded by
  ``max_prefill_tokens``), one batched decode dispatch for all active
  slots, retire finished sequences and refill their slots mid-flight.
  Records TTFT/TPOT/queue-depth/slot-occupancy into the telemetry
  registry.

- :mod:`admission` — priority classes, deadline and SLO shedding,
  backpressure and the autoscale policy (pure decisions, stdlib only).
- :mod:`replay` — seeded request mixes, arrival processes and the
  open-loop replayer (stdlib only).
- :mod:`shipping` — the wire format, handoff claims and the fleet prefix
  index of disaggregated prefill/decode serving (numpy only).
- :mod:`deploy` — continuous deployment: checkpoint following, the
  pre-swap gate over the port's checkpoints, canarying, promotion and
  rollback.
- :mod:`server` — the front half (request queue, worker thread, drain on
  SIGTERM, artifacts) and the file-queue replica
  (``python -m distributed_tensorflow_models_tpu_torch.serving.server``).

``server``, ``admission``, ``replay``, ``shipping`` and ``deploy`` import
no torch: a supervisor loads them without the device stack.  This
``__init__`` deliberately imports nothing, as in the JAX package: callers
import submodules explicitly.
"""

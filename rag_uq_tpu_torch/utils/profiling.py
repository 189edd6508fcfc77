"""The port's tracer: named spans and counters at the program's batch boundaries.

Turn it on, run, take the records::

    from rag_uq_tpu_torch.utils import profiling

    profiling.enable()
    retriever.hybrid_search_batch(queries, sparse_mode="scatter")
    rec = profiling.take()        # {"spans": [...], "counters": {...}, "dropped": n}
    profiling.disable()
    searches = {s.id for s in rec["spans"] if s.name == "search"}
    hash_ms = [s.host_ms for s in rec["spans"] if s.name == "embed.hash" and s.root in searches]
    fused_ms = [s.cuda_ms for s in rec["spans"] if s.name == "fused"]   # None off the card

Off (the default) a span is one check of a module global that returns a
shared no-op context, and a counter one check and a return: no clock, no
CUDA event, no ``record_function``, no allocation. Spans and counters sit
only at batch boundaries, never inside a loop over queries or features.

On, each span records its name, ``perf_counter_ns`` start and end, its own
id, its parent's id (None at the top) and its root's id, from a stack kept
per thread, so spans of concurrent callers keep their own trees; and ``n``,
the items the span handles where the caller gives it (the batch size of a
``search``). With ``cuda=True`` a span also records a pair of CUDA events on
the current stream; their time is read in ``take``, never while the program
runs, and no span synchronizes the device. Each span also opens
``torch.profiler.record_function(name)``, so a ``torch.profiler`` trace
carries the program's spans on its own clock, where they can name the
device's idle gaps.

Records are kept in memory up to ``CAP`` spans; spans past it are counted
in ``dropped``. ``take`` returns what was kept and clears it; ``counters``
reads the counters so far without clearing them.

Spans (where; clock):

- ``search`` (``HybridRetriever.hybrid_search_batch``, one a call, ``n`` = B)
  with ``search.state`` (``_fused_state``) and ``search.readback`` (the
  results' copy to the host, which waits for the device);
- ``embed`` (``DenseIndex.embed_queries``) with ``embed.hash``
  (``NgramHashEmbedder._hash_batch``), ``embed.bag`` (``encode_device``;
  also CUDA), ``embed.readback`` (``encode``'s copy to the host) and
  ``embed.upload`` (normalize, copy to the device, pad);
- ``terms`` (``retrieval/fused.py::encode_for_fused``) with
  ``terms.tokenize`` (``BM25Index.encode_queries``) and ``terms.compact``
  (the high tier's active-row compaction and its copies);
- ``fused`` (the fused query) with ``fused.dense_pool``, ``fused.bm25_pool``
  and ``fused.tail`` (the union, the fusion and the top-k); host and CUDA;
- ``generate`` (``llm/deepseek_v2.py::DeepseekV2LM.generate_batch_scored``,
  which ``llm/kimi_linear.py::KimiLinearLM`` runs too; one a call, ``n`` =
  rows) with ``generate.encode`` (tokenizing the distinct prompts, the
  slots, the uploads), ``generate.prefill`` (each distinct prompt once;
  host and CUDA, ``n`` = prompt tokens), ``generate.fork`` (the slots'
  caches, the KDA layers' states and conv tails copied to each slot
  included, and first samples; host and CUDA),
  ``generate.decode`` (the decode loop; host and CUDA, ``n`` = steps) and
  ``generate.readback`` (the samples' copy to the host and their texts);
- per layer, ``mla`` (a latent-attention block), ``kda`` (a Kimi Delta
  Attention block) and ``moe`` (the expert layer; ``mlp`` for a dense one):
  ``device_range``s, which name the device trace's kernels only while a
  ``torch.profiler`` records and keep no span;
- set-up: ``bm25.build`` (``BM25Index.add_documents``), ``bm25.sync`` (a
  rebuild of its device layout), ``dense.add`` (``DenseIndex.add_documents``
  and ``add_precomputed``), ``build.compile`` (a native library compiled).

Counters: ``bm25.high_rows_active`` and ``bm25.high_rows_padded`` (a scatter
batch's distinct high-tier rows and the rows its product runs over);
``bm25.high_product_tc`` (high-tier products taken 16 x 16 -> f32 on the
card's tensor cores, one a pool call there; the CPU's f32 product counts
none, ``ops/bm25.py::high_tier``);
``embed.hash_native`` and ``embed.hash_python`` (texts whose hashed features
the native library computed, and texts the Python twin hashed because the
library did not load, in ``text/tokenize.py::hash_texts``, which
``NgramHashEmbedder._hash_batch`` and the encoder call);
``bm25.syncs``, ``fused_state.rebuilds``, ``build.compiles`` and
``build.cache_hits`` (what was built again); for the generator, a call's
``gen.rows``, ``gen.prompts`` (distinct prompts prefilled),
``gen.prefill_tokens``, ``gen.prefill_pairs`` (causal query-key pairs of
the prefill, sum of L (L + 1) / 2), ``gen.decode_steps``,
``gen.decode_positions`` (steps times rows), ``gen.cache_positions`` (the
cached positions each row's decode steps attend over, summed), ``gen.tokens``
(tokens generated, EOS included), ``moe.pairs`` (token-expert pairs an
expert layer routed) and ``mla.decode_kernel`` (launches of the latent
attention's decode kernel, ``ops/mla_decode.py::cuda_mla_decode``: one a
layer a decode step on the card, so a window's count is the layers times
its ``gen.decode_steps``; the CPU's plain path counts none);
``moe.local_pairs`` (the pairs an expert share computed, those routed to
the experts it holds; counted on the device, ``count_device``); and for
KDA layers (``ops/kda.py``) ``kda.prefill_tokens`` (prompt tokens a call's
prefill ran through them), ``kda.prefill_kernel`` (launches of the prefill
kernel, ``cuda_kda_prefill``: one a KDA layer a prefill on the card, none
on the CPU, whose chunked form counts none), ``kda.decode_kernel``
(launches of the decode kernel, ``cuda_kda_decode``: one a KDA layer a
decode step on the card, none on the CPU) and ``kda.state_bytes`` (the
states' bytes a decode step read and wrote, twice a state's size a layer a
step, either path).

``count_device`` adds a one-element device tensor's value, read only when
the counters are (``counters``, ``take``), so counting never waits for the
device.

A span's ``n`` may be set inside its block (``with span(...) as s:``,
``s`` None while off). ``device_sync`` is a barrier on the device of a tensor.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch

CAP = 1 << 16

_NOOP = contextlib.nullcontext()
_on = False
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_kept: List[tuple] = []
_dropped = 0
_counters: Dict[str, int] = defaultdict(int)
# (name, one-element device tensor) counted but not read yet.
_pending: List[tuple] = []


class Span(NamedTuple):
    """One finished span. ``root`` is the id of the outermost span open in
    its thread when it started (its own id at the top); ``cuda_ms`` is None
    for a span without CUDA events."""

    id: int
    parent: Optional[int]
    root: int
    name: str
    start_ns: int
    end_ns: int
    n: Optional[int]
    cuda_ms: Optional[float]

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class _Open:
    __slots__ = ("name", "n", "cuda", "id", "parent", "root", "label", "events", "t0")

    def __init__(self, name: str, cuda: bool, n: Optional[int]):
        self.name, self.cuda, self.n = name, cuda, n

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self.label = torch.profiler.record_function(self.name)
        self.label.__enter__()
        self.events = None
        if self.cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self.label.__exit__(None, None, None)
        _stack().pop()
        _keep((self.id, self.parent, self.root, self.name, self.t0, t1, self.n, self.events))
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(record: tuple) -> None:
    global _dropped
    with _lock:
        if len(_kept) < CAP:
            _kept.append(record)
        else:
            _dropped += 1


def enable() -> None:
    """Record spans and counters from here on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``take``."""
    global _on
    _on = False


def span(name: str, cuda: bool = False, n: Optional[int] = None):
    """A context manager recording ``name`` while the tracer is on (CUDA
    events too with ``cuda``); the shared no-op context while it is off."""
    if not _on:
        return _NOOP
    return _Open(name, cuda, n)


def device_range(name: str):
    """A ``torch.profiler`` range of ``name`` while the tracer is on and a
    profiler is recording, else the shared no-op context: no span is kept,
    so ranges opened once a layer a step cannot fill the cap."""
    if not _on or not torch.autograd._profiler_enabled():
        return _NOOP
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    if not _on:
        return
    with _lock:
        _counters[name] += int(n)


def count_device(name: str, n: torch.Tensor) -> None:
    """Add the value of the one-element tensor ``n`` to the counter ``name``
    while the tracer is on. It is read with the counters, so counting never
    waits for the device."""
    if not _on:
        return
    with _lock:
        _pending.append((name, n))


def _settle() -> None:
    """Read the pending device counts into the counters (under ``_lock``)."""
    for name, n in _pending:
        _counters[name] += int(n)
    _pending.clear()


def counters() -> Dict[str, int]:
    """The counters counted since the last ``take``, left as they are."""
    with _lock:
        _settle()
        return dict(_counters)


def take() -> Dict:
    """The spans finished and the counters counted since the last ``take``,
    and the spans dropped past the cap; clears them. Reads the CUDA events,
    waiting for each span's end event."""
    global _kept, _dropped
    with _lock:
        _settle()
        kept, dropped, counters = _kept, _dropped, dict(_counters)
        _kept, _dropped = [], 0
        _counters.clear()
    spans = []
    for sid, parent, root, name, t0, t1, n, events in kept:
        cuda_ms = None
        if events is not None:
            events[1].synchronize()
            cuda_ms = events[0].elapsed_time(events[1])
        spans.append(Span(sid, parent, root, name, t0, t1, n, cuda_ms))
    return {"spans": spans, "counters": counters, "dropped": dropped}


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def device_sync(x=None) -> None:
    """Barrier: wait for the device work queued so far. With ``x`` (a
    tensor or a nest of them), on the device of its first tensor; without,
    on the current card when there is one. CPU tensors need no barrier."""
    t = _first_tensor(x)
    if t is not None:
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize()

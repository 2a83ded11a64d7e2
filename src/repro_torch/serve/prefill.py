"""Chunked prefill and the serving step: one decode step over static
buffers, run as a chunk of steps, eagerly or replayed from a CUDA graph.

Port of ``src/repro/serve/prefill.py``, where a chunk is one ``lax.scan``
under ``jit`` so that it lands in the cache as one compiled program. Here a
chunk is up to ``C`` replays of *the* decode step
(``models.kvcache.decode_forward``): step ``t`` feeds ``tokens[:, t]`` at
``pos + t`` with the slot mask ``active = t < n_tok``, so the ops run for
active slots are exactly those of token-by-token teacher-forced replay.
Steps past the longest slot's count write nothing and select nothing, so
the chunk stops there. A decode tick is a chunk of one step with ``n_tok``
the tick's active mask.

``ServeStep`` keeps the step's inputs in buffers on the device that are
written in place (``tokens``, ``pos``, ``n_tok`` and the step counter
``t``), so the step's device work is one fixed program: with ``graph`` it
is captured once as a CUDA graph and every step of every chunk replays it.
The counter advances on the device, inside the step. Between two steps the
host issues the cache hook's ``commit`` (the paged cache's page-boundary
flush, whose target depends on the data) on the same stream.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import build
from repro_torch.models import kvcache as KV
from repro_torch.models.layers import torch_dtype


class ServeStep:
    """One decode step over a ``(batch, chunk)`` token block, bound to
    ``params`` and ``cache`` (written in place).

    ``run(tokens, pos, n_tok)`` feeds ``tokens[b, :n_tok[b]]`` into slot
    b's cache from ``pos[b]`` on (``pos`` and ``n_tok`` are read on the
    host). Afterwards ``last`` holds the logits of each slot's final fed
    token (zeros where ``n_tok == 0``) and ``next_tok`` their greedy argmax
    (int32), both on the device.

    ``graph=True`` (CUDA only) captures the step as a CUDA graph at once
    and replays it; a failed capture or replay raises. The kernels' launch
    counts (``kernels.build``) are recorded during the capture and added on
    every replay.

    On a mesh (``layout``, a ``train.step_builder.ServeLayout`` of more
    than one rank) ``params`` and ``cache`` are this rank's: its weight
    shards, the cache of its slots (``layout.slots``) and heads. ``run``
    still takes the whole batch's inputs and keeps this rank's rows; every
    rank replays the step as often (the whole batch's longest count), so
    their collectives pair up. ``last`` holds this rank's slots and vocab
    slice; after the chunk ``next_tok`` is the whole batch's, the argmax
    over the model group all-gathered over the data group
    (``ServeLayout.greedy``). ``gather`` (``dist.collectives.ServeGather``)
    makes weights sharded over the data ranks whole at use. The step runs
    eagerly there: a CUDA graph is captured only at a world of one
    (capturing NCCL collectives cannot be checked on one card, and gloo's
    host-side collectives cannot be captured).
    """

    def __init__(self, params: dict, cache: dict, cfg: ModelConfig, kv_io, *, batch: int,
                 chunk: int, device, graph: bool = False, layout=None, gather=None):
        device = torch.device(device)
        self.layout = layout
        self.distributed = layout is not None and layout.world > 1
        if graph and self.distributed:
            raise NotImplementedError(
                f"a CUDA graph of a serving step over {layout.world} ranks (ROADMAP.md): "
                "pass graph=False")
        if graph and device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        self.params, self.cache, self.cfg = params, cache, cfg
        self.kv_io = kv_io or KV.RESIDENT_KV
        self.gather = gather
        self.batch, self.chunk, self.device = batch, chunk, device
        self.rows = layout.rows if self.distributed else slice(0, batch)
        slots = self.rows.stop - self.rows.start
        vocab = (params["embed"]["tok"].shape[0] if cfg.tie_embeddings
                 else params["head"]["w"].shape[-1]) if self.distributed else cfg.vocab_size
        i64 = dict(dtype=torch.int64, device=device)
        self.tokens = torch.zeros((slots, chunk), **i64)
        self.pos = torch.zeros((slots,), **i64)
        self.n_tok = torch.zeros((slots,), **i64)
        self.t = torch.zeros((), **i64)
        self.last = torch.zeros((slots, vocab), dtype=torch_dtype(cfg.dtype), device=device)
        self.next_tok = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[str, int] = {}  # kernel launches of one replay
        self.replays = 0  # steps run, eagerly or from the graph
        if graph:
            self.capture()

    def step(self) -> None:
        """One step's device work on the buffers; reads nothing back."""
        t = self.t
        tok = self.tokens.gather(1, t.expand(self.tokens.shape[0], 1))
        lay = self.layout if self.distributed else None
        logits = KV.decode_forward(self.params, self.cache, tok, self.pos + t, self.cfg,
                                   kv_io=self.kv_io, active=t < self.n_tok,
                                   tp=lay and lay.tp, route=lay and lay.route,
                                   gather=self.gather)
        take = (t == self.n_tok - 1)[:, None]
        self.last.copy_(torch.where(take, logits, self.last))
        if not self.distributed:
            self.next_tok.copy_(torch.argmax(self.last, dim=-1))
        t.add_(1)

    def capture(self) -> None:
        """Warm the step up on a side stream with every slot inactive (no
        cache byte changes), each warm-up step at step 0 (the counter stays
        inside a chunk of one), then capture it in the default ("global")
        error mode."""
        self.n_tok.zero_()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.inference_mode(), torch.cuda.stream(side):
            for _ in range(2):
                self.t.zero_()
                self.step()
        current.wait_stream(side)
        self.t.zero_()
        before = build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(graph):
            self.step()
        after = build.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        build.set_launch_counts(before)  # the capture launched nothing
        self.graph = graph

    def replay_once(self) -> None:
        """The step's device work once: the graph, or the step launched eagerly."""
        self.replays += 1
        if self.graph is None:
            with torch.inference_mode():
                self.step()
        else:
            self.graph.replay()
            build.add_launches(self.launches)

    def run(self, tokens, pos, n_tok) -> None:
        pos, n_tok = KV.host_positions(pos), KV.host_positions(n_tok)
        rows = self.rows
        self.tokens.copy_(torch.as_tensor(tokens)[rows])
        self.pos.copy_(pos[rows])
        self.n_tok.copy_(n_tok[rows])
        self.t.zero_()
        self.last.zero_()
        self.next_tok.zero_()
        # the whole batch's longest count: every rank steps alike
        steps = min(self.chunk, int(n_tok.max())) if self.batch else 0
        for i in range(steps):
            self.replay_once()
            self.kv_io.commit(self.cache, pos[rows] + i, self.cfg, active=i < n_tok[rows])
        if self.distributed:
            with torch.inference_mode():
                self.next_tok.copy_(self.layout.greedy(self.last, self.cfg))


def prefill_chunk(params: dict, cache: dict, tokens: torch.Tensor, pos, n_tok,
                  cfg: ModelConfig, *, kv_io=None):
    """Feed ``tokens[b, :n_tok[b]]`` into slot b's cache from ``pos[b]`` on,
    eagerly.

    tokens: (B, C) on the model's device; pos, n_tok: (B,) ints, read on the
    host. Returns ``(last_logits, cache)``: ``last_logits[b]`` are the logits
    of slot b's final fed token (zeros where ``n_tok == 0``); the cache is
    written in place.
    """
    b, c = tokens.shape
    step = ServeStep(params, cache, cfg, kv_io, batch=b, chunk=c, device=tokens.device)
    step.run(tokens, pos, n_tok)
    return step.last, cache

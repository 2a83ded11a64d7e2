"""Page-table KV cache: hot ring on the device, cold store in pinned host memory.

Port of ``src/repro/serve/paging.py``. Each attention position's
(B, S, n_kv, hd) decode cache is split along the sequence into pages backed
by two stores:

  * ``k_hot``/``v_hot`` -- a device ring of the last ``hot_window`` slots
    (``n_hot`` pages). Every decoded token is written at ``slot % W``.
  * ``k_cold``/``v_cold`` -- the canonical full cache. On CUDA it is
    **pinned host memory**, mapped into the device's address space (unified
    addressing), so the paged-attention kernel reads cold rows in place,
    with no staging copy. Under the page-boundary flush (``flush=True``, the
    default) a completed page is copied hot -> cold once per ``page_size``
    steps; under write-through (``flush=False``) cold receives every token.

Cold-store writes are stream-ordered: the flush is a ``non_blocking`` copy
on the current stream, so a kernel launched later on that stream sees it
and one launched earlier is not raced. A CPU-side write to the pinned store
(the engine's slot reset) may only happen once the stream is idle
(``assert_stream_idle``).

Exactness: rows the hot ring does not hold canonically are taken from cold
(``sel``); stale rows of masked slots get exactly zero softmax weight under
the additive ``NEG_INF`` mask. With ``use_kernel`` the attention runs in
the paged kernel (``kernels.decode_paged_attention``: the CUDA kernel on
CUDA tensors, its plain version on CPU tensors); without it the cache is
rebuilt row by row and attended by ``_masked_decode_attn`` -- the reference
the kernel is held against. The per-step ``sel`` and ``mask`` depend only
on the positions, so they are built once per step (``prepare``) and shared
by every layer.

``PagedKV.h2d_bytes`` counts the cold-store bytes attention reads: on CUDA
the cold store is pinned host memory, so these are the bytes that cross the
host link. The kernel reads K and V of the attended cold rows only; the
rebuild path copies each layer's whole cold store.

The ring-correctness invariant requires ``n_pages % n_hot == 0``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import decode_paged_attention
from repro_torch.models import kvcache as KV
from repro_torch.models.layers import NEG_INF


@dataclasses.dataclass(frozen=True)
class PagingSpec:
    """Page geometry for one serve configuration."""

    page_size: int  # tokens per page (P)
    n_pages: int  # pages spanning the cache length
    n_hot: int  # pages of the hot window (>= 1, divides n_pages)

    def __post_init__(self):
        assert self.page_size >= 1 and self.n_pages >= 1
        assert 1 <= self.n_hot <= self.n_pages
        assert self.n_pages % self.n_hot == 0, (
            "hot window must tile the page ring (SWA ring-slot correctness)")

    @property
    def cache_len(self) -> int:
        return self.page_size * self.n_pages

    @property
    def hot_window(self) -> int:
        return self.page_size * self.n_hot

    @property
    def n_cold(self) -> int:
        return self.n_pages - self.n_hot


def choose_paging(cache_len: int, page_size: int, n_hot: int) -> PagingSpec:
    """Clamp (page_size, n_hot) to a valid spec for ``cache_len``: the
    largest page size dividing ``cache_len`` not above the request, then the
    largest ``n_hot`` dividing the page count."""
    page_size = max(1, min(page_size, cache_len))
    while cache_len % page_size:
        page_size -= 1
    n_pages = cache_len // page_size
    n_hot = max(1, min(n_hot, n_pages))
    while n_pages % n_hot:
        n_hot -= 1
    return PagingSpec(page_size=page_size, n_pages=n_pages, n_hot=n_hot)


# ---------------------------------------------------------------------------
# Paged cache trees
# ---------------------------------------------------------------------------
def paged_cache_specs(cfg: ModelConfig, batch: int, seq_len: int, spec: PagingSpec) -> dict:
    """``{pos<j>: {name: (shape, dtype)}}`` of the paged decode cache."""
    base = KV.cache_specs(cfg, batch, seq_len)
    assert spec.cache_len == KV.cache_len(cfg, seq_len), (
        f"paging spec covers {spec.cache_len} slots, cache has "
        f"{KV.cache_len(cfg, seq_len)}")
    out = {}
    for pos, entry in base.items():
        (r, b, _, n_kv, hd), dt = entry["k"]
        hot = ((r, b, spec.hot_window, n_kv, hd), dt)
        out[pos] = {"k_hot": hot, "v_hot": hot, "k_cold": entry["k"], "v_cold": entry["v"]}
    return out


def init_paged_cache(cfg: ModelConfig, batch: int, seq_len: int, spec: PagingSpec,
                     device="cpu") -> dict:
    """Zeros matching ``paged_cache_specs``: hot rings on ``device``; cold
    stores in pinned host memory when ``device`` is CUDA, else on ``device``."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def zeros(name, shape, dt):
        if name.endswith("_cold") and pin:
            return torch.zeros(shape, dtype=dt, pin_memory=True)
        return torch.zeros(shape, dtype=dt, device=device)

    return {pos: {name: zeros(name, *sd) for name, sd in entry.items()}
            for pos, entry in paged_cache_specs(cfg, batch, seq_len, spec).items()}


def paged_to_resident(cache: dict) -> dict:
    """Resident-layout view of a paged cache: the cold store, canonical for
    every completed page (and for every row under write-through)."""
    return {pos: {"k": e["k_cold"], "v": e["v_cold"]} for pos, e in cache.items()}


# ---------------------------------------------------------------------------
# Decode-time cache I/O (the kv_io hook of models.kvcache.decode_step)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PagedStep:
    """One decode step's host decisions and device tensors, shared by all layers."""

    rope: torch.Tensor  # device RoPE positions
    hot_write: KV.SlotWrite  # ring write, slot % W
    mask: torch.Tensor  # device (B, S) fp32
    sel: torch.Tensor  # device (B, S) bool: ring row canonical
    flush_pages: list[tuple[int, int]]  # (batch row, page) copied hot -> cold
    cold_rows: list[tuple[int, int]]  # write-through: (batch row, slot)
    cold_reads: int  # (batch row, slot) pairs the kernel reads from cold, per layer


class PagedKV:
    """Paged cache I/O for one decode step.

    ``flush`` selects the cold-store write policy: ``True`` (default) copies
    a completed page hot -> cold once per ``page_size`` steps; ``False``
    writes every token through to cold (the reference policy).

    ``use_kernel`` (default ``True``) sends attention through
    ``kernels.decode_paged_attention`` (the CUDA kernel for CUDA tensors);
    ``False`` rebuilds the cache and runs ``_masked_decode_attn``.
    """

    entry_keys = ("k_hot", "v_hot", "k_cold", "v_cold")

    def __init__(self, spec: PagingSpec, flush: bool = True, use_kernel: bool = True):
        self.spec = spec
        self.flush = flush
        self.use_kernel = use_kernel
        self.h2d_bytes = 0  # cold-store bytes read by attention, all steps

    # -- page residency (host tensors) ----------------------------------------
    def _hot_mask(self, wp: torch.Tensor, p: int, sliding: bool) -> torch.Tensor:
        """Is logical page ``p`` fully servable from the hot ring for a slot
        at write page ``wp``? Full attention: the last ``n_hot`` pages
        including the write page. Sliding rings: only the ``n_hot - 1`` most
        recent fully written pages (the write page's not-yet-rewritten rows
        hold values older than the hot window)."""
        s = self.spec
        if sliding:
            d = (wp - p) % s.n_pages
            return (d >= 1) & (d < s.n_hot)
        return (wp >= p) & (wp - p < s.n_hot)

    def _page_is_hot(self, wp: torch.Tensor, p: int, sliding: bool) -> torch.Tensor:
        return torch.all(self._hot_mask(wp, p, sliding))

    def _take_hot_rows(self, wp: torch.Tensor, slot: torch.Tensor, p: int,
                       sliding: bool) -> torch.Tensor:
        """Flush-mode row residency of page ``p``: True where the ring holds
        the canonical value. Full attention: the whole hot window, write page
        included. Sliding rings also split the write page by row: rows this
        cycle already rewrote (``row <= slot % P``) are in the ring."""
        s = self.spec
        if not sliding:
            return self._hot_mask(wp, p, sliding).reshape(-1, 1)
        d = ((wp - p) % s.n_pages).reshape(-1)
        full = (d >= 1) & (d < s.n_hot)
        rows = torch.arange(s.page_size)
        written = rows[None, :] <= (slot % s.page_size).reshape(-1, 1)
        return full[:, None] | ((d == 0)[:, None] & written)

    def _row_residency(self, wp, slot, sliding: bool, batch: int) -> torch.Tensor:
        """(B, S) host bool: True where the hot ring holds the row."""
        s = self.spec
        cols = []
        for p in range(s.n_pages):
            if self.flush:
                take = self._take_hot_rows(wp, slot, p, sliding)
            else:
                take = self._page_is_hot(wp, p, sliding).reshape(1, 1)
            cols.append(torch.broadcast_to(take, (batch, s.page_size)))
        return torch.cat(cols, dim=1)

    # -- per-step preparation -------------------------------------------------
    def prepare(self, cache: dict, pos, cfg: ModelConfig, device, active=None) -> PagedStep:
        s = self.spec
        pos = KV.host_positions(pos)
        act = None if active is None else torch.as_tensor(active).to("cpu", torch.bool)
        batch = next(iter(cache.values()))["k_hot"].shape[1]
        sliding = bool(cfg.sliding_window)
        slot = pos % s.cache_len if sliding else pos
        wp = slot // s.page_size
        per_row = slot.expand(batch) if slot.ndim == 0 else slot
        writes = [True] * batch if act is None else act.tolist()
        flush_pages, cold_rows = [], []
        for b in range(batch):
            sl = int(per_row[b])
            if not writes[b]:
                continue
            if not self.flush:
                cold_rows.append((b, sl))
            elif (sl + 1) % s.page_size == 0:
                flush_pages.append((b, sl // s.page_size))
        mask = torch.broadcast_to(KV.decode_mask(pos, s.cache_len, sliding),
                                  (batch, s.cache_len))
        sel = self._row_residency(wp, slot, sliding, batch)
        return PagedStep(
            rope=KV.rope_positions(pos).to(device),
            hot_write=KV.SlotWrite.build(slot % s.hot_window, act, device),
            mask=mask.contiguous().to(device),
            sel=sel.to(device),
            flush_pages=flush_pages,
            cold_rows=cold_rows,
            cold_reads=int((attended_rows(mask) & ~sel).sum()))

    # -- the per-token cache write ----------------------------------------------
    def _write(self, entry: dict, k, v, step: PagedStep) -> None:
        """Hot-ring write, then the flush (or write-through) cold update --
        copies on the current stream, after the ring write they read."""
        P = self.spec.page_size
        for name, val in (("k", k), ("v", v)):
            hot, cold = entry[f"{name}_hot"], entry[f"{name}_cold"]
            KV.write_slot(hot, val, step.hot_write)
            for b, page in step.flush_pages:
                r0 = (page % self.spec.n_hot) * P
                cold[b, page * P:(page + 1) * P].copy_(hot[b, r0:r0 + P], non_blocking=True)
            for b, sl in step.cold_rows:
                cold[b, sl].copy_(val[b, 0], non_blocking=True)

    def update_and_fetch(self, entry: dict, k, v, step: PagedStep):
        """Write, then rebuild the full (B, S, kv, hd) cache row by row:
        ring row ``s % W`` where ``sel`` is set, else cold row ``s``."""
        self._write(entry, k, v, step)
        self.h2d_bytes += entry["k_cold"].nbytes + entry["v_cold"].nbytes
        sel = step.sel[..., None, None]
        dev = entry["k_hot"].device
        ring = torch.arange(self.spec.cache_len, device=dev) % self.spec.hot_window
        full_k = torch.where(sel, entry["k_hot"][:, ring],
                             entry["k_cold"].to(dev, non_blocking=True))
        full_v = torch.where(sel, entry["v_hot"][:, ring],
                             entry["v_cold"].to(dev, non_blocking=True))
        return full_k, full_v, step.mask

    def attend(self, entry: dict, q, k, v, step: PagedStep):
        """Fused write + attend (``models.kvcache._decode_attention``).
        Returns (B, 1, Hq, hd)."""
        if not self.use_kernel:
            full_k, full_v, mask = self.update_and_fetch(entry, k, v, step)
            return KV._masked_decode_attn(q, full_k, full_v, mask)
        self._write(entry, k, v, step)
        self.h2d_bytes += 2 * step.cold_reads * entry["k_cold"][0, 0].nbytes
        return decode_paged_attention(q, entry["k_hot"], entry["v_hot"], entry["k_cold"],
                                      entry["v_cold"], step.sel, step.mask,
                                      n_hot=self.spec.n_hot)


def attended_rows(mask: torch.Tensor) -> torch.Tensor:
    """(B, S) rows the paged kernel reads: the unmasked ones, or every row of
    a batch entry with none unmasked (its softmax weighs them all equally)."""
    valid = mask > NEG_INF
    return valid | ~valid.any(dim=1, keepdim=True)


def assert_stream_idle(cache: dict) -> None:
    """Raise unless a CPU-side write to the pinned cold store is safe: every
    copy or kernel queued on the current CUDA stream has finished."""
    for entry in cache.values():
        for leaf in entry.values():
            if leaf.device.type == "cpu" and leaf.is_pinned():
                if not torch.cuda.current_stream().query():
                    raise RuntimeError("host write to the pinned cold store while the "
                                       "CUDA stream still runs work that reads it")
                return


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------
def cache_partition_bytes(cfg: ModelConfig, batch: int, seq_len: int,
                          spec: PagingSpec | None) -> dict[str, int]:
    """Bytes of the decode cache by residence tier: ``hbm`` (hot rings, or
    the whole resident cache), ``host`` (cold store), ``transient`` (one
    attention position's gathered full cache -- the rebuild path's largest
    per-layer reconstruction; the kernel path builds none)."""
    base = KV.cache_specs(cfg, batch, seq_len)
    hbm = host = transient = 0
    for entry in base.values():
        for _, (shape, dt) in entry.items():
            nbytes = dt.itemsize
            for d in shape:
                nbytes *= d
            if spec is None:
                hbm += nbytes
                continue
            hbm += nbytes * spec.n_hot // spec.n_pages  # hot ring
            host += nbytes  # canonical cold store
            transient = max(transient, 2 * nbytes // shape[0])
    return {"hbm": hbm, "host": host, "transient": transient if spec else 0}

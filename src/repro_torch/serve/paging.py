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

The step's device work (``prepare`` and the attention hooks) builds every
index from device positions with tensor ops, so a CUDA graph can capture
it. Device kernels write the pinned cold store through ``device_view``, a
CUDA tensor over the same bytes. Write-through's per-token cold write is a
fixed-shape write like the ring's, so it stays in the step, ahead of the
attention that reads it. The page-boundary flush depends on the data (which
slot completes a page this step), so it is not part of the step: ``commit``
issues it from host positions after the step, on the current stream,
before the next step is launched. The page completed by a step is read
from cold only once it has left the hot window, never by the step that
completes it, so copying it after that step gives the bytes the JAX
package's in-step ``lax.cond`` gives. A CPU-side write to the pinned store
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
host link. On a mesh each rank holds the cache of its slots and heads and
counts its own bytes. The kernel reads K and V of the attended cold rows only; the
rebuild path copies each layer's whole cold store. ``commit`` counts them
from host positions with the same functions the step runs on the device.

A Mamba-2 position's recurrent state (``conv``, ``ssm``) is not paged: it
stays on the device, as in the resident layout, and is written in place
through the step's ``state`` write. Nor is an encoder-decoder's
cross-attention cache (``xk``, ``xv``): it stays resident on the device.

The ring-correctness invariant requires ``n_pages % n_hot == 0``.
"""
from __future__ import annotations

import dataclasses
import types

import torch

from repro_torch.compat import faking, pinned_empty, tensor_key
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import decode_paged_attention
from repro_torch.models import kvcache as KV
from repro_torch.models.layers import NEG_INF

CROSS_KEYS = ("xk", "xv")  # an encoder-decoder's cross cache: resident, never paged


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
def paged_cache_specs(cfg: ModelConfig, batch: int, seq_len: int, spec: PagingSpec,
                      tp=None) -> dict:
    """``{pos<j>: {name: (shape, dtype)}}`` of the paged decode cache:
    attention positions split into hot ring and cold store, Mamba-2 state as
    in the resident layout. ``tp``: a model rank's heads, ``batch`` its
    slots (``KV.cache_specs``)."""
    base = KV.cache_specs(cfg, batch, seq_len, tp)
    assert spec.cache_len == KV.cache_len(cfg, seq_len), (
        f"paging spec covers {spec.cache_len} slots, cache has "
        f"{KV.cache_len(cfg, seq_len)}")
    out = {}
    for pos, entry in base.items():
        if "k" not in entry:
            out[pos] = dict(entry)
            continue
        (r, b, _, n_kv, hd), dt = entry["k"]
        hot = ((r, b, spec.hot_window, n_kv, hd), dt)
        out[pos] = {"k_hot": hot, "v_hot": hot, "k_cold": entry["k"], "v_cold": entry["v"],
                    **{x: entry[x] for x in CROSS_KEYS if x in entry}}
    return out


def init_paged_cache(cfg: ModelConfig, batch: int, seq_len: int, spec: PagingSpec,
                     device="cpu", tp=None) -> dict:
    """Zeros matching ``paged_cache_specs``: hot rings on ``device``; cold
    stores in pinned host memory when ``device`` is CUDA, else on ``device``.
    ``tp``: a model rank's cache over its heads and slots, the cold pages
    of a rank in its host's pinned memory."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def zeros(name, shape, dt):
        if name.endswith("_cold") and pin:
            return pinned_empty(shape, dt).zero_()
        return torch.zeros(shape, dtype=dt, device=device)

    return {pos: {name: zeros(name, *sd) for name, sd in entry.items()}
            for pos, entry in paged_cache_specs(cfg, batch, seq_len, spec, tp).items()}


def device_view(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t``'s bytes as a tensor on ``device``: ``t`` itself where it lies
    there; a pinned host tensor seen from a CUDA device is a CUDA tensor
    over the same memory (unified addressing maps pinned host memory into
    the device's address space at its host address), which device kernels
    read and write in place."""
    if t.device == device:
        return t
    if faking():  # the dry-run's fake tensors: no memory to map, a fake one on the device
        return torch.empty(t.shape, dtype=t.dtype, device=device)
    if not (t.device.type == "cpu" and t.is_pinned() and t.is_contiguous()):
        raise ValueError(f"a view on {device} needs a contiguous pinned host tensor, "
                         f"got {t.device} (pinned={t.is_pinned()})")
    raw = t.reshape(-1).view(torch.uint8)
    # the CUDA array interface over t's bytes; the view holds it, and it holds t
    mem = types.SimpleNamespace(owner=t, __cuda_array_interface__={
        "shape": (raw.numel(),), "typestr": "|u1", "data": (raw.data_ptr(), False),
        "version": 2})
    view = torch.as_tensor(mem, device=device)
    if view.device != device or view.data_ptr() != t.data_ptr():
        raise RuntimeError(f"pinned memory at {t.data_ptr():#x} is not mapped on {device}")
    return view.view(t.dtype).view(t.shape)


def paged_to_resident(cache: dict) -> dict:
    """Resident-layout view of a paged cache: the cold store, canonical for
    every completed page (and for every row under write-through), the
    cross-attention cache and the Mamba-2 state as they are."""
    return {pos: {"k": e["k_cold"], "v": e["v_cold"], **{x: e[x] for x in CROSS_KEYS if x in e}}
            if "k_cold" in e else dict(e) for pos, e in cache.items()}


# ---------------------------------------------------------------------------
# Decode-time cache I/O (the kv_io hook of models.kvcache.decode_step)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PagedStep:
    """One decode step's device tensors, shared by all layers."""

    rope: torch.Tensor  # device RoPE positions
    hot_write: KV.SlotWrite  # ring write, slot % W
    cold_write: KV.SlotWrite | None  # write-through's cold write, slot
    mask: torch.Tensor  # device (B, S) fp32
    sel: torch.Tensor  # device (B, S) bool: ring row canonical
    active: torch.Tensor | None  # device bool (B,), None if every slot is: the state's write


class PagedKV:
    """Paged cache I/O for one decode step.

    ``flush`` selects the cold-store write policy: ``True`` (default) copies
    a completed page hot -> cold once per ``page_size`` steps; ``False``
    writes every token through to cold (the reference policy).

    ``use_kernel`` (default ``True``) sends attention through
    ``kernels.decode_paged_attention`` (the CUDA kernel for CUDA tensors);
    ``False`` rebuilds the cache and runs ``_masked_decode_attn``.
    """

    def __init__(self, spec: PagingSpec, flush: bool = True, use_kernel: bool = True):
        self.spec = spec
        self.flush = flush
        self.use_kernel = use_kernel
        self.h2d_bytes = 0  # cold-store bytes read by attention, all steps
        self._views: dict[tuple, torch.Tensor] = {}  # cold leaf (tensor_key) -> device view

    def _device_view(self, cold: torch.Tensor, device: torch.device) -> torch.Tensor:
        """``device_view`` of a whole cold leaf, made once (before a CUDA
        graph's capture, by its warm-up): the step only slices it. Made
        outside inference mode, so that ``commit`` may write it there too."""
        if cold.device == device:
            return cold
        view = self._views.get(tensor_key(cold))
        if view is None:
            with torch.inference_mode(False):
                view = self._views[tensor_key(cold)] = device_view(cold, device)
        return view

    def layer_entry(self, pos_cache: dict, r: int) -> dict:
        """Layer ``r``'s leaves of one attention position, with the cold
        store also as a device view (``k_cold_dev``, ``v_cold_dev``) that
        write-through writes, and its cross cache if it has one; of a
        Mamba-2 position, its state."""
        if "k_hot" not in pos_cache:
            return {name: leaf[r] for name, leaf in pos_cache.items()}
        dev = pos_cache["k_hot"].device
        entry = {name: pos_cache[name][r] for name in ("k_hot", "v_hot", "k_cold", "v_cold")
                 + CROSS_KEYS if name in pos_cache}
        for name in ("k", "v"):
            entry[f"{name}_cold_dev"] = self._device_view(pos_cache[f"{name}_cold"], dev)[r]
        return entry

    # -- page residency (the JAX package's traced formulation) -----------------
    def _hot_mask(self, wp: torch.Tensor, p, sliding: bool) -> torch.Tensor:
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

    def _take_hot_rows(self, wp: torch.Tensor, slot: torch.Tensor, rows: torch.Tensor,
                       sliding: bool) -> torch.Tensor:
        """Flush-mode row residency, (B, S): True where the ring holds the
        canonical value. Full attention: the whole hot window, write page
        included. Sliding rings also split the write page by row: rows this
        cycle already rewrote (``row <= slot % P``) are in the ring."""
        s = self.spec
        page = rows // s.page_size
        if not sliding:
            return self._hot_mask(wp, page, sliding)
        d = (wp - page) % s.n_pages
        full = (d >= 1) & (d < s.n_hot)
        written = rows % s.page_size <= slot % s.page_size
        return full | ((d == 0) & written)

    def residency(self, slot: torch.Tensor, sliding: bool) -> torch.Tensor:
        """``sel``, (B, S) bool on ``slot``'s device: True where the hot ring
        holds the row. ``slot``: (B,) per-slot cache slot. Under
        write-through a page comes from the ring only when it is hot for
        every batch row (the JAX ``_page_is_hot``)."""
        s = self.spec
        rows = torch.arange(s.cache_len, device=slot.device)[None, :]
        col = slot[:, None]
        wp = col // s.page_size
        if self.flush:
            return self._take_hot_rows(wp, col, rows, sliding)
        hot = self._hot_mask(wp, rows // s.page_size, sliding).all(dim=0, keepdim=True)
        return hot.expand(slot.shape[0], s.cache_len).contiguous()

    def _slots(self, pos: torch.Tensor, batch: int, sliding: bool) -> torch.Tensor:
        slot = pos % self.spec.cache_len if sliding else pos
        return slot.expand(batch)

    # -- per-step preparation (device) ---------------------------------------------
    def prepare(self, cache: dict, pos, cfg: ModelConfig, device, active=None) -> PagedStep:
        s = self.spec
        pos = KV.device_positions(pos, device)
        act = None if active is None else torch.as_tensor(active).to(device, torch.bool)
        batch = KV.batch_size(cache)
        sliding = bool(cfg.sliding_window)
        slot = self._slots(pos, batch, sliding)
        mask = torch.broadcast_to(KV.decode_mask(pos, s.cache_len, sliding),
                                  (batch, s.cache_len)).contiguous()
        return PagedStep(
            rope=KV.rope_positions(pos),
            hot_write=KV.SlotWrite.build(slot % s.hot_window, act, batch, s.hot_window),
            cold_write=None if self.flush else KV.SlotWrite.build(slot, act, batch, s.cache_len),
            mask=mask,
            sel=self.residency(slot, sliding),
            active=act)

    # -- the per-token cache write and attention (device) -------------------------
    def _write(self, entry: dict, k, v, step: PagedStep) -> None:
        """The ring write; under write-through also the cold write, ahead of
        the attention that reads it."""
        KV.write_slot(entry["k_hot"], k, step.hot_write)
        KV.write_slot(entry["v_hot"], v, step.hot_write)
        if step.cold_write is not None:
            KV.write_slot(entry["k_cold_dev"], k, step.cold_write)
            KV.write_slot(entry["v_cold_dev"], v, step.cold_write)

    def update_and_fetch(self, entry: dict, k, v, step: PagedStep):
        """Write, then rebuild the full (B, S, kv, hd) cache row by row:
        ring row ``s % W`` where ``sel`` is set, else cold row ``s``."""
        self._write(entry, k, v, step)
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
        return decode_paged_attention(q, entry["k_hot"], entry["v_hot"], entry["k_cold"],
                                      entry["v_cold"], step.sel, step.mask,
                                      n_hot=self.spec.n_hot)

    # -- after the step (host) --------------------------------------------------------
    def flushed_pages(self, pos, batch: int, sliding: bool, active=None) -> list[tuple]:
        """The pages the step completed, decided on the host from host
        positions: ``(batch row, first cold row, first ring row)`` for each
        slot that wrote its page's last row. None under write-through."""
        s = self.spec
        if not self.flush:
            return []
        slot = self._slots(KV.host_positions(pos), batch, sliding).tolist()
        writes = [True] * batch if active is None else torch.as_tensor(active).tolist()
        out = []
        for b, (sl, w) in enumerate(zip(slot, writes)):
            if w and (sl + 1) % s.page_size == 0:
                page = sl // s.page_size
                out.append((b, page * s.page_size, (page % s.n_hot) * s.page_size))
        return out

    def commit(self, cache: dict, pos, cfg: ModelConfig, active=None) -> None:
        """The step's host-side work, from host ``pos`` and ``active``: count
        the cold bytes its attention read, then copy the pages it completed
        hot -> cold (``flushed_pages``) on the current stream, after the
        step's device work and before any later step's: one copy per leaf
        and page, across the layers."""
        s = self.spec
        attn = KV.attention_entries(cache)
        if not attn:
            return
        pos = KV.host_positions(pos)
        act = None if active is None else torch.as_tensor(active).to("cpu", torch.bool)
        leaf = attn[0]["k_cold"]
        batch = leaf.shape[1]
        sliding = bool(cfg.sliding_window)
        layers = sum(entry["k_cold"].shape[0] for entry in attn)
        row_bytes = leaf[0, 0, 0].nbytes
        if self.use_kernel:
            mask = KV.decode_mask(pos, s.cache_len, sliding)
            sel = self.residency(self._slots(pos, batch, sliding), sliding)
            rows = int((attended_rows(mask.expand(batch, s.cache_len)) & ~sel).sum())
        else:
            rows = batch * s.cache_len  # the rebuild copies the whole cold store
        self.h2d_bytes += layers * 2 * rows * row_bytes
        pages = self.flushed_pages(pos, batch, sliding, act)
        n = s.page_size
        for entry in attn:
            for name in ("k", "v"):
                hot = entry[f"{name}_hot"]
                cold = self._device_view(entry[f"{name}_cold"], hot.device)
                for b, c0, h0 in pages:
                    cold[:, b, c0:c0 + n].copy_(hot[:, b, h0:h0 + n])


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
                          spec: PagingSpec | None, tp=None) -> dict[str, int]:
    """Bytes of the decode cache by residence tier: ``hbm`` (hot rings and
    Mamba-2 state, or the whole resident cache), ``host`` (cold store),
    ``transient`` (one attention position's gathered full cache -- the
    rebuild path's largest per-layer reconstruction; the kernel path builds
    none). ``tp``, ``batch``: a rank's heads and slots."""
    base = KV.cache_specs(cfg, batch, seq_len, tp)
    hbm = host = transient = 0
    for entry in base.values():
        for name, (shape, dt) in entry.items():
            nbytes = dt.itemsize
            for d in shape:
                nbytes *= d
            if spec is None or name not in ("k", "v"):
                hbm += nbytes
                continue
            hbm += nbytes * spec.n_hot // spec.n_pages  # hot ring
            host += nbytes  # canonical cold store
            transient = max(transient, 2 * nbytes // shape[0])
    return {"hbm": hbm, "host": host, "transient": transient if spec else 0}

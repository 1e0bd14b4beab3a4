"""Paged/block KV cache: device-side block pools plus a host-side free-list
allocator and per-request block tables; the counterpart of
``repro/serve/paged_cache.py``.

Storage is a per-layer pool of fixed-size blocks ``(n_pool, block_size,
kv, hd)`` whose last row is the *trash block* (inactive batch rows write
there). Requests address the pool through int32 block tables, one table
per *layout group* (``models.transformer.cache_layout``):

* ``"full"``: full-attention layers. Each request reserves
  ``ceil((prompt + n_new) / block_size)`` blocks from a free list at
  admission, so the decode loop never allocates, and releases them at
  eviction. Unreserved table entries point at the trash block and are
  masked off by ``slot <= index``.
* ``"ring{R}"``: sliding-window layers. Every ring slot stays live, so
  each batch slot owns its ``R / block_size`` blocks for good and the
  table is static.

Recycling a slot needs no zeroing: the validity masks already exclude a
previous tenant's stale blocks.

SSM layers carry a per-slot recurrent state ``(n_slots, ...)`` in float32
instead of blocks: admission overwrites the slot's row, and the decode
step freezes inactive rows.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, dtype_of
from repro_torch.device import resolve_device
from repro_torch.models.ssm import init_ssm_state
from repro_torch.models.transformer import PagedKV, cache_layout


class PagedCache:
    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 block_size: int = 16, dtype=torch.bfloat16,
                 full_blocks: Optional[int] = None, device=None):
        """``full_blocks`` caps the full-group physical pool (default: fully
        provisioned, ``n_slots * ceil(max_len / block_size)``); a smaller
        budget makes admission wait on the free list."""
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.device = resolve_device(device)
        self.layout = cache_layout(cfg, max_len, block_size)

        self._group_phys: Dict[str, int] = {}
        for name, g in self.layout["groups"].items():
            if g["ring"] is not None or full_blocks is None:
                self._group_phys[name] = n_slots * g["n_blk"]
            else:
                self._group_phys[name] = full_blocks

        self._tables_np: Dict[str, np.ndarray] = {}
        for name, g in self.layout["groups"].items():
            if g["ring"] is not None:
                nb = g["n_blk"]
                t = np.arange(n_slots * nb, dtype=np.int32).reshape(
                    n_slots, nb)
            else:
                # everything starts unmapped: point at the trash block
                t = np.full((n_slots, g["n_blk"]), self._group_phys[name],
                            np.int32)
            self._tables_np[name] = t
        self._tables_dev: Optional[Dict[str, torch.Tensor]] = None

        self._free: List[int] = list(range(self._group_phys.get("full", 0)))
        self._owned: Dict[int, List[int]] = {}

        dt = dtype_of(dtype)
        self.pools: Dict[str, Dict] = {}
        for i in range(cfg.n_layers):
            lay = self.layout["layers"][f"L{i}"]
            ent: Dict = {}
            if "attn" in lay:
                shape = (self._group_phys[lay["attn"]["group"]] + 1,
                         block_size, cfg.n_kv_heads, cfg.head_dim)
                ent["attn"] = PagedKV(
                    k=torch.zeros(shape, dtype=dt, device=self.device),
                    v=torch.zeros(shape, dtype=dt, device=self.device))
            if "ssm" in lay:
                ent["ssm"] = init_ssm_state(n_slots, cfg.d_model, cfg.ssm,
                                            torch.float32, self.device)
            self.pools[f"L{i}"] = ent

    # -- block tables -------------------------------------------------------

    @property
    def tables(self) -> Dict[str, torch.Tensor]:
        if self._tables_dev is None:
            self._tables_dev = {k: torch.tensor(v, device=self.device)
                                for k, v in self._tables_np.items()}
        return self._tables_dev

    def blocks_needed(self, n_tokens: int) -> int:
        if "full" not in self.layout["groups"]:
            return 0
        return -(-n_tokens // self.block_size)

    def can_admit(self, n_tokens: int) -> bool:
        return self.blocks_needed(n_tokens) <= len(self._free)

    def free_blocks(self) -> int:
        return len(self._free)

    def used_width(self) -> Optional[int]:
        """Width (in blocks) of the full-group table prefix that reserved
        blocks back, bucketed up to a multiple of four. ``reserve`` fills
        each row as a contiguous prefix, so slicing to this width drops only
        trash-mapped (masked-off) columns. None when the config has no
        full-attention group or nothing is reserved."""
        if "full" not in self.layout["groups"]:
            return None
        used = max((len(b) for b in self._owned.values()), default=0)
        if used == 0:
            return None
        n_blk = self.layout["groups"]["full"]["n_blk"]
        return min(n_blk, 4 * (-(-used // 4)))

    def reserve(self, slot: int, n_tokens: int) -> None:
        """Reserve the request's whole token budget up front so the decode
        loop never allocates."""
        need = self.blocks_needed(n_tokens)
        if need > len(self._free):
            raise RuntimeError(
                f"paged cache exhausted: need {need} blocks for slot {slot}, "
                f"{len(self._free)} free")
        blocks = [self._free.pop() for _ in range(need)]
        self._owned[slot] = blocks
        if need:
            self._tables_np["full"][slot, :need] = blocks
            self._tables_dev = None

    def release(self, slot: int) -> None:
        self._free.extend(self._owned.pop(slot, []))
        for name, g in self.layout["groups"].items():
            if g["ring"] is None:
                self._tables_np[name][slot, :] = self._group_phys[name]
        self._tables_dev = None

    # -- admission ----------------------------------------------------------

    def write_prefill(self, slot: int, mono_cache: Dict, n_prompt: int,
                      row: int = 0) -> None:
        """Scatter row ``row`` of a monolithic ``prefill`` cache into the
        pools at ``slot``, in place. Linear layers take mono positions
        ``0..n_prompt-1``; ring layers re-place the retained tail from the
        mono ring layout (slot ``p % size``) onto the padded ring (slot
        ``p % R``). Index arrays are built on the host, once for each
        layout group. SSM layers copy the row's state into the slot's."""
        bs = self.block_size
        idx: Dict[tuple, tuple] = {}
        for i in range(self.cfg.n_layers):
            lay = self.layout["layers"][f"L{i}"]
            if "ssm" in lay:
                pool, st = self.pools[f"L{i}"]["ssm"], mono_cache[f"L{i}"]["ssm"]
                pool.s[slot] = st.s[row]
                pool.conv[slot] = st.conv[row]
            if "attn" not in lay:
                continue
            al = lay["attn"]
            kv = mono_cache[f"L{i}"]["kv"]
            size_m = kv.k.shape[1]
            if (al["group"], size_m) not in idx:
                keep = min(n_prompt, size_m)
                pos = np.arange(n_prompt - keep, n_prompt)
                src = pos % size_m          # == pos when nothing wrapped
                ring = al["ring"]
                new_slot = pos % ring if ring is not None else pos
                pb = self._tables_np[al["group"]][slot, new_slot // bs]
                idx[al["group"], size_m] = tuple(
                    torch.from_numpy(a.astype(np.int64)).to(self.device)
                    for a in (pb, new_slot % bs, src))
            pb_t, off_t, src_t = idx[al["group"], size_m]
            pool = self.pools[f"L{i}"]["attn"]
            pool.k[pb_t, off_t] = kv.k[row, src_t].to(pool.k.dtype)
            pool.v[pb_t, off_t] = kv.v[row, src_t].to(pool.v.dtype)

"""Host-side KV page tiers behind the paged cache.

Counterpart of ``paddle_tpu/serving/kv_tier.py`` (a copy, not an
import). ``PagedKVCache``'s only on-device answer to page pressure is
the LRU reclaim, which destroys cold refcount-0 prefix pages: every
reclaimed system-prompt page is a future full-price prefill. This module
adds the two tiers below the device pool:

- :class:`HostPageTier`: host-RAM payloads keyed by the radix chunk
  path. ``_reclaim_one`` DEMOTES cold pages here instead of freeing
  them; a radix hit on a demoted chunk PROMOTES the payload back into a
  freshly allocated device page before the extend runs. RAM residency
  is LRU-bounded (``capacity_pages``), with write-through to the
  optional persistent store underneath.
- :class:`PersistentPrefixStore`: one file per chunk under the host
  tier, written atomically (a temp file, then ``os.replace``), so shared
  system prompts stay warm across ``recover()`` and process restarts. A
  torn or unreadable chunk file reads as ABSENT (and is unlinked), never
  as corrupt data.

Keys are the full token path from the radix root (a tuple of ints, a
multiple of ``page_size`` long): the path IS the identity of a prefix
page, so the cache only rehydrates keys whose whole ancestor chain
survived.

Payloads are per-page host tensors stacked over layers: ``k``/``v`` are
``[num_layers, page_size, kv_heads, head_dim]`` in the pool dtype (int8
when the pool is quantized) and ``ks``/``vs`` the ``[num_layers,
page_size, kv_heads]`` f32 scales (empty, shape ``(0,)``, when not
quantized). On a CUDA pool they are page-locked (``pin_payloads``: the
demotion copies into pinned buffers, and a payload read back from disk
is pinned before it is handed out), so the promotion's H2D copy runs
from pinned memory. On disk a bf16 tensor is stored as its raw 16 bits
(an int16 array; numpy has no bf16) and ``meta.json`` records
``"bfloat16"``.

Pinning of keys mirrors the device refcounts one level up:
``try_reserve`` pins the host keys it plans to promote, and neither a
pinned key nor any ancestor of one is evictable until the plan commits
or unwinds (``resilience.invariants.page_leak_violations`` audits every
pin back to zero at quiesce).
"""
from __future__ import annotations

import hashlib
import json
import os
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["HostPageTier", "PersistentPrefixStore"]

Key = Tuple[int, ...]

_PAYLOAD_FIELDS = ("k", "v", "ks", "vs")


def _key_file(key: Key) -> str:
    h = hashlib.sha1(repr(tuple(int(t) for t in key)).encode()).hexdigest()
    return f"chunk-{h}.npz"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as a numpy array; bf16 as its raw 16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == torch.bfloat16:
        if t.dtype != torch.int16:
            raise ValueError(f"bf16 payload stored as {t.dtype}")
        return t.view(torch.bfloat16)
    if t.dtype != dtype:
        raise ValueError(f"payload dtype {t.dtype} != {dtype}")
    return t


class PersistentPrefixStore:
    """Disk tier: one atomic ``.npz`` file per demoted chunk.

    Files carry the key (``ids``) plus the payload arrays, written to a
    temp name and ``os.replace``d into place: a crash mid-write leaves
    either the old file or a ``.tmp`` orphan, never a half-visible
    entry. Reads treat ANY load failure as absence and unlink the torn
    file (the store is a cache of recomputable KV, so dropping a bad
    entry is always safe).

    A ``meta.json`` records the pool geometry; opening a directory whose
    geometry differs from the engine's drops the stale entries (they
    index a different pool shape and could never be installed).
    """

    def __init__(self, path: str, *, num_layers: int, page_size: int,
                 kv_heads: int, head_dim: int, dtype: torch.dtype,
                 quant: bool):
        self.path = path
        self.dtype = dtype
        self.quant = bool(quant)
        self.geometry = {
            "num_layers": int(num_layers),
            "page_size": int(page_size),
            "kv_heads": int(kv_heads),
            "head_dim": int(head_dim),
            "dtype": _dtype_name(dtype),
            "quant": bool(quant),
        }
        os.makedirs(path, exist_ok=True)
        self._check_geometry()

    def _check_geometry(self) -> None:
        meta_p = os.path.join(self.path, "meta.json")
        stale = False
        if os.path.exists(meta_p):
            try:
                with open(meta_p) as f:
                    stale = json.load(f) != self.geometry
            except Exception:
                stale = True        # torn meta: entries unverifiable
        if stale:
            for name in os.listdir(self.path):
                if name.startswith("chunk-"):
                    try:
                        os.unlink(os.path.join(self.path, name))
                    except OSError:
                        pass
        tmp = meta_p + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.geometry, f)
        os.replace(tmp, meta_p)

    def _file(self, key: Key) -> str:
        return os.path.join(self.path, _key_file(key))

    def put(self, key: Key, payload: Dict[str, torch.Tensor]) -> None:
        target = self._file(key)
        tmp = target + ".tmp"
        arrays = {f: _to_numpy(payload[f]) for f in _PAYLOAD_FIELDS}
        arrays["ids"] = np.asarray(key, np.int64)
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)

    def get(self, key: Key) -> Optional[Dict[str, torch.Tensor]]:
        p = self._file(key)
        kv = torch.int8 if self.quant else self.dtype
        try:
            with np.load(p) as z:
                out = {f: _from_numpy(z[f], kv if f in ("k", "v")
                                      else torch.float32)
                       for f in _PAYLOAD_FIELDS}
                ids = z["ids"]
            if tuple(int(t) for t in ids) != tuple(key):
                raise ValueError("key mismatch (hash collision?)")
            return out
        except FileNotFoundError:
            return None
        except Exception:
            # torn-write tolerance: an interrupted or corrupt file is
            # ABSENT, and unlinked so it cannot shadow a future put
            try:
                os.unlink(p)
            except OSError:
                pass
            return None

    def has(self, key: Key) -> bool:
        return os.path.exists(self._file(key))

    def drop(self, key: Key) -> None:
        try:
            os.unlink(self._file(key))
        except OSError:
            pass

    def keys(self) -> List[Key]:
        """Every readable key on disk (torn files are dropped on the
        way): the rehydration scan on cache construction."""
        out: List[Key] = []
        for name in sorted(os.listdir(self.path)):
            if not (name.startswith("chunk-") and name.endswith(".npz")):
                continue
            p = os.path.join(self.path, name)
            try:
                with np.load(p) as z:
                    ids = z["ids"]
                out.append(tuple(int(t) for t in ids))
            except Exception:
                try:
                    os.unlink(p)
                except OSError:
                    pass
        return out


class HostPageTier:
    """Host-RAM page tier with LRU eviction, pinning, and optional
    write-through to a :class:`PersistentPrefixStore`.

    ``put`` returns False when the entry cannot be admitted (RAM at
    capacity with nothing evictable and no disk tier underneath): the
    cache then falls back to destroying the page, the untiered
    behaviour. Eviction never drops a pinned key or an ancestor of one
    (a promotion plan needs the whole chain), and with a store present
    eviction only sheds the RAM copy (the disk copy keeps the key
    resident). ``pin_payloads``: payloads read back from the store are
    page-locked before they are handed out (a CUDA pool's tier)."""

    def __init__(self, num_layers: int, page_size: int, kv_heads: int,
                 head_dim: int, dtype: torch.dtype, quant: bool = False,
                 capacity_pages: Optional[int] = None,
                 store: Optional[PersistentPrefixStore] = None,
                 on_evict: Optional[Callable[[Key], None]] = None,
                 pin_payloads: bool = False):
        if capacity_pages is not None and capacity_pages < 1:
            raise ValueError(
                f"capacity_pages must be >= 1 or None, got "
                f"{capacity_pages}")
        self.num_layers = int(num_layers)
        self.page_size = int(page_size)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = torch.int8 if quant else dtype
        self.quant = bool(quant)
        self.capacity_pages = capacity_pages
        self.store = store
        self.pin_payloads = bool(pin_payloads)
        # the cache installs this: called when a key leaves the tier
        # entirely (no disk copy) so the radix subtree unlinks with it
        self.on_evict = on_evict
        self._ram: "OrderedDict[Key, Dict[str, torch.Tensor]]" = \
            OrderedDict()
        self._pins: Dict[Key, int] = {}
        self.ram_evictions = 0

    # -- payload shape law ------------------------------------------------
    def _check_payload(self, payload: Dict[str, torch.Tensor]) -> None:
        L, P, H, D = (self.num_layers, self.page_size, self.kv_heads,
                      self.head_dim)
        for f in ("k", "v"):
            a = payload[f]
            if tuple(a.shape) != (L, P, H, D) or a.dtype != self.dtype:
                raise ValueError(
                    f"payload {f!r} shape/dtype {tuple(a.shape)}/"
                    f"{a.dtype} does not match tier geometry "
                    f"({(L, P, H, D)}/{self.dtype})")
        want_sc = (L, P, H) if self.quant else (0,)
        for f in ("ks", "vs"):
            a = payload[f]
            if tuple(a.shape) != want_sc:
                raise ValueError(
                    f"payload {f!r} shape {tuple(a.shape)} does not match "
                    f"tier scale geometry {want_sc}")

    # -- pinning ----------------------------------------------------------
    def pin(self, key: Key) -> None:
        self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key: Key) -> None:
        n = self._pins.get(key, 0) - 1
        if n < 0:
            raise RuntimeError(f"host tier pin underflow for {key!r}")
        if n:
            self._pins[key] = n
        else:
            self._pins.pop(key, None)

    def reset_pins(self) -> None:
        """A fresh cache (init / recover) owns no plans: whatever the
        dead cache pinned is unreachable and must not block eviction."""
        self._pins.clear()

    def pin_counts(self) -> Dict[Key, int]:
        return dict(self._pins)

    def _pin_blocked(self, key: Key) -> bool:
        """A key is unevictable while it, or any DESCENDANT key, is
        pinned: dropping an ancestor chunk would orphan the pinned
        promotion plan's chain."""
        for p in self._pins:
            if len(p) >= len(key) and p[:len(key)] == key:
                return True
        return False

    # -- residency --------------------------------------------------------
    def put(self, key: Key, payload: Dict[str, torch.Tensor]) -> bool:
        key = tuple(int(t) for t in key)
        self._check_payload(payload)
        if self.store is not None:
            # write-through FIRST: once the disk copy exists, shedding
            # the RAM copy under pressure never loses the key
            self.store.put(key, payload)
        self._ram[key] = payload
        self._ram.move_to_end(key)
        if not self._shrink_to_capacity():
            # nothing evictable and no disk tier: refuse, the caller
            # falls back to destroying the page
            self._ram.pop(key, None)
            return False
        # the shrink may have evicted the entry just admitted (every
        # OTHER key pinned): success only if the key is still resident
        return self.has(key)

    def _shrink_to_capacity(self) -> bool:
        if self.capacity_pages is None:
            return True
        while len(self._ram) > self.capacity_pages:
            victim = None
            for k in self._ram:              # OrderedDict: LRU first
                if not self._pin_blocked(k):
                    victim = k
                    break
            if victim is None:
                return False
            self.ram_evictions += 1
            if self.store is not None and self.store.has(victim):
                self._ram.pop(victim, None)  # disk keeps it resident
            elif self.on_evict is not None:
                # the cache unlinks the radix subtree, dropping this key
                # (and any descendant keys) through drop()
                self.on_evict(victim)
                self._ram.pop(victim, None)  # in case on_evict didn't
            else:
                self._ram.pop(victim, None)
        return True

    def get(self, key: Key) -> Optional[Dict[str, torch.Tensor]]:
        key = tuple(int(t) for t in key)
        got = self._ram.get(key)
        if got is not None:
            self._ram.move_to_end(key)
            return got
        if self.store is not None:
            got = self.store.get(key)
            if got is not None and self.pin_payloads:
                got = {f: t.pin_memory() for f, t in got.items()}
            return got
        return None

    def where(self, key: Key) -> Optional[str]:
        key = tuple(int(t) for t in key)
        if key in self._ram:
            return "host"
        if self.store is not None and self.store.has(key):
            return "disk"
        return None

    def has(self, key: Key) -> bool:
        return self.where(key) is not None

    def drop(self, key: Key) -> None:
        """Remove the key from BOTH tiers (the subtree unlink path)."""
        key = tuple(int(t) for t in key)
        self._ram.pop(key, None)
        if self.store is not None:
            self.store.drop(key)

    def drop_ram(self, key: Key) -> None:
        """Shed only the RAM copy (promotion commit: the page is on the
        device again; the disk copy, if any, stays warm for the next
        restart)."""
        self._ram.pop(tuple(int(t) for t in key), None)

    def keys(self) -> List[Key]:
        """Every resident key (RAM and disk): the rehydration set."""
        out = dict.fromkeys(self._ram)
        if self.store is not None:
            for k in self.store.keys():
                out.setdefault(k, None)
        return list(out)

    def ram_keys(self) -> List[Key]:
        return list(self._ram)

    def host_page_count(self) -> int:
        return len(self._ram)

    def host_bytes(self) -> int:
        """Host bytes of the RAM-resident payloads."""
        return sum(t.numel() * t.element_size()
                   for p in self._ram.values() for t in p.values())

    def stats(self) -> Dict[str, int]:
        return {"host_pages": len(self._ram),
                "ram_evictions": self.ram_evictions,
                "pinned_keys": len(self._pins)}

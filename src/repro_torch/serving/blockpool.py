"""Host-side block allocator + prefix cache for the paged KV serve path.

The port's copy of ``repro.serving.blockpool`` (pure Python and numpy).
Numpy has no bfloat16, so a bf16 pool's handoff buffers carry its raw
16-bit patterns as int16: the fingerprint names the pool's torch dtype,
and the importer views the buffers back as that dtype on the device.

The device holds one block pool per attention layer, all indexed by the
SAME physical block ids; the allocator hands out ids, so one host-side
free list manages every layer's memory at once.  Block 0 is reserved as
the scratch block: freed slots keep decoding (cheaper than masking the
batched matmuls) and their garbage writes land there, never in a live
request's blocks.

Invariants:

* a refcount never goes negative — double-free raises;
* a block returns to the free list exactly when its refcount hits 0, so
  evicting a request returns every block it exclusively owned;
* prefix-shared blocks are copy-on-write safe BY CONSTRUCTION: only FULL
  blocks strictly below the admitted prompt's write frontier are ever
  shared, and both decode and chunked prefill write at positions at or
  beyond that frontier — a shared block is never a write target, so no
  copy is ever needed (sharing is a block-table entry + a refcount bump);
* the engine allocates a request's worst-case reach (prompt + budget,
  capped at max_len) at admission, so decode can never fail mid-flight.

The prefix cache is hash-keyed per model image (each engine owns its
allocator, and the chain hash covers the exact padded token bytes), maps
``hash(padded_tokens[: (j+1) * block_size])`` to the physical block
holding positions ``[j*bs, (j+1)*bs)``, and holds one reference on every
published block so prefixes outlive their first request.  Under pool
pressure, unreferenced prefix blocks (refcount 1 — cache-only) are
evicted oldest-first.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np


class BlockAllocator:
    """Free-list + refcount allocator over ``num_blocks`` physical blocks
    (block 0 reserved as scratch, never handed out)."""

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks >= 2, "need at least scratch + one real block"
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = list(range(num_blocks - 1, 0, -1))     # LIFO
        self._refs = np.zeros(num_blocks, np.int32)

    # -- capacity ------------------------------------------------------

    @property
    def capacity_blocks(self) -> int:
        return self.num_blocks - 1                          # minus scratch

    @property
    def capacity_tokens(self) -> int:
        return self.capacity_blocks * self.block_size

    @property
    def allocated_blocks(self) -> int:
        return self.capacity_blocks - len(self._free)

    @property
    def available_blocks(self) -> int:
        return len(self._free)

    # -- alloc / share / free ------------------------------------------

    def alloc(self) -> int:
        """Pop a free block (refcount 1)."""
        if not self._free:
            raise RuntimeError("block pool exhausted")
        bid = self._free.pop()
        self._refs[bid] = 1
        return bid

    def share(self, bid: int) -> int:
        """Bump a live block's refcount (prefix reuse)."""
        assert self._refs[bid] > 0, f"share of dead block {bid}"
        self._refs[bid] += 1
        return bid

    def free(self, bid: int):
        """Drop one reference; the block returns to the free list at 0."""
        if bid == 0:
            return                                          # scratch
        if self._refs[bid] <= 0:
            raise RuntimeError(f"refcount underflow on block {bid}")
        self._refs[bid] -= 1
        if self._refs[bid] == 0:
            self._free.append(bid)

    def refcount(self, bid: int) -> int:
        return int(self._refs[bid])


class PrefixCache:
    """Chain-hash -> physical block map for full prompt blocks.

    Keys cover the exact PADDED token bytes up to each block boundary, so
    a hit guarantees bit-identical KV content (positions and tokens both
    match).  The cache holds one reference per published block; evicting
    an entry drops that reference."""

    def __init__(self, alloc: BlockAllocator):
        self._alloc = alloc
        self._map: OrderedDict[bytes, int] = OrderedDict()  # key -> bid
        self.lookups = 0
        self.hits = 0

    @staticmethod
    def block_keys(padded_tokens: np.ndarray, block_size: int,
                   n_blocks: int) -> list[bytes]:
        """Chain-hash keys for the first ``n_blocks`` FULL blocks of a
        padded prompt: key_j = H(tokens[: (j+1) * bs])."""
        toks = np.ascontiguousarray(padded_tokens, np.int32)
        return [hashlib.sha1(toks[: (j + 1) * block_size].tobytes()).digest()
                for j in range(n_blocks)]

    def match(self, keys: list[bytes]) -> list[int]:
        """Longest-prefix match: returns the physical ids of the leading
        blocks already cached (refcounts bumped — caller owns one ref per
        returned block)."""
        out = []
        for key in keys:
            self.lookups += 1
            bid = self._map.get(key)
            if bid is None:
                break
            self.hits += 1
            out.append(self._alloc.share(bid))
        return out

    def publish(self, key: bytes, bid: int):
        """Register a freshly-filled full block (cache takes one ref)."""
        if key in self._map:
            return                                          # raced: keep first
        self._map[key] = self._alloc.share(bid)
        self._map.move_to_end(key)

    def evict_unreferenced(self, want_blocks: int) -> int:
        """Drop oldest cache-only entries (refcount 1) until
        ``want_blocks`` are freed or nothing evictable remains."""
        freed = 0
        for key in list(self._map):
            if freed >= want_blocks:
                break
            bid = self._map[key]
            if self._alloc.refcount(bid) == 1:              # cache-only
                del self._map[key]
                self._alloc.free(bid)
                freed += 1
        return freed

    def clear(self):
        for key, bid in list(self._map.items()):
            self._alloc.free(bid)
        self._map.clear()

    def __len__(self):
        return len(self._map)


# --------------------------------------------------------------------------
# KV block handoff: the disaggregated prefill -> decode wire format
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KVHandoff:
    """A finished prompt's KV, packaged for import into ANOTHER engine's
    block pool — the payload a prefill pilot hands to the decode fleet.

    ``blocks`` is one dict per attention layer, each mapping a paged pool
    key (``kp``/``vp`` for GQA, ``ckvp``/``kropep`` for MLA) to a host
    buffer of shape ``(groups, n_prompt_blocks, block_size, ...)`` — the
    slot's block chain gathered contiguously (device-side gather, one
    host pull for the whole pytree).  Because chunk boundaries, padding
    and bucket shapes are identical on both sides, scattering these
    buffers into the importer's pool reproduces the exporter's KV rows
    bit for bit.

    ``block_hashes`` carries the exporter's chain-hash keys over the
    padded prompt, so the importer can (a) skip scattering blocks its own
    :class:`PrefixCache` already holds and (b) republish the fresh full
    blocks under the SAME keys — prefix sharing survives the handoff.

    ``fingerprint`` pins everything the scatter relies on (block size
    plus every paged leaf's pool layout and dtype); an importer whose
    pools disagree must reject the handoff rather than write garbage.

    ``first_token`` is the admission-time argmax — the one token prefill
    produced.  A decode engine that installs ``pos = plen``, ``token =
    first_token`` and the scattered blocks holds EXACTLY the state a
    unified engine holds after admission, which is why the resumed greedy
    stream is bitwise identical (DESIGN.md "Disaggregated prefill/decode").
    """

    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32, unpadded
    plen: int                          # admission bucket (padded length)
    first_token: int                   # argmax of the prefill logits
    max_new_tokens: int                # decode budget riding along
    block_hashes: tuple                # chain-hash keys, one per FULL block
    fingerprint: tuple                 # (block_size, per-layer pool layout)
    blocks: list                       # per-layer {key: np.ndarray} buffers

    @property
    def n_prompt_blocks(self) -> int:
        bs = self.fingerprint[0]
        return -(-self.plen // bs)

    @property
    def nbytes(self) -> int:
        """Handoff wire size: what actually crosses pools per request."""
        return sum(int(buf.nbytes)
                   for leaf in self.blocks for buf in leaf.values())

    def validate_against(self, fingerprint: tuple):
        """Raise unless the importer's pools can hold these buffers."""
        if fingerprint != self.fingerprint:
            raise ValueError(
                f"handoff fingerprint mismatch for rid {self.rid}: "
                f"exporter {self.fingerprint!r} vs importer "
                f"{fingerprint!r}; prefill and decode images must share "
                f"the arch, block size and KV dtype")

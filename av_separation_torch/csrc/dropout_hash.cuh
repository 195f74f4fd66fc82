// Attention-dropout keep test shared by the flash forward and backward
// kernels: the stateless murmur3-finalizer hash of the JAX package's
// `_keep_mask` (av_separation_tpu/ops/pallas/attention.py:147-160), keyed by
// the Pallas grid's tile coordinates.  For element (row t, key c) of head
// bh: tile (bh, t / hq, c / hk) and in-tile (t % hq, c % hk), where
// hq = min(512, ceil16(Tq)) and hk = min(512, ceil128(Tk)) are the Pallas
// block sizes.  The same bits as the plain version (`keep_mask` in
// ops/kernels/attention.py) and the JAX kernels under the interpreter.
#pragma once

struct DropoutHash {
  unsigned seed;       // int32 call seed, as uint32
  unsigned threshold;  // keep when hash >= threshold
  int hq, hk;          // hash tile sizes
  int on;              // rate > 0
};

// Row part of the hash: the tile term of the query block and the in-tile
// row term, computed once per row.
struct HashRow {
  unsigned tile;  // seed, bh and query-block terms, XORed
  unsigned row;   // in-tile row term
};

__device__ __forceinline__ HashRow hash_row(const DropoutHash& d, int bh,
                                            int t) {
  HashRow r;
  r.tile = (d.seed * 0x9E3779B9u) ^ (static_cast<unsigned>(bh) * 0x85EBCA6Bu) ^
           (static_cast<unsigned>(t / d.hq) * 0xC2B2AE35u);
  r.row = static_cast<unsigned>(t % d.hq) * 0x01000193u;
  return r;
}

__device__ __forceinline__ bool hash_keep(const DropoutHash& d, HashRow r,
                                          int c) {
  unsigned h = r.row + static_cast<unsigned>(c % d.hk) * 0x61C88647u +
               (r.tile ^ (static_cast<unsigned>(c / d.hk) * 0x27D4EB2Fu));
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >= d.threshold;
}

"""Workload / data-distribution models for benchmarks and tests.

Replaces the reference's external R datagen (generate-data.sh ->
db-benchmark join-datagen.R) with native generators shaped like the same
suites: J1-style uniform key tables at small/medium/big build ratios, plus
the skew models (Zipf) the distributed tier must survive.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class JoinCase:
    """One benchmark case: build side (keys+values) and probe side (keys)."""
    name: str
    build_keys: np.ndarray
    build_values: np.ndarray
    probe_keys: np.ndarray


def j1_suite(n: int, seed: int = 0) -> list[JoinCase]:
    """db-benchmark J1-shaped suite for probe size n.

    Q1: build = n/1e6 rows (tiny), Q2: n/1e3 (medium), Q5: n (big) —
    the numeric-key cases benchmark.py actually runs (Q4's factor key is
    skipped there too, benchmark.py:223-228).  Keys are uniform over
    1.1x the build count, like join-datagen's key universe.
    """
    rng = np.random.default_rng(seed)
    cases = []
    for qid, ratio in (("Q1", 1_000_000), ("Q2", 1_000), ("Q5", 1)):
        nb = max(n // ratio, 1)
        universe = max(int(nb * 1.1), 2)
        bk = rng.integers(0, universe, nb, dtype=np.uint64)
        # db-benchmark's v2 payload is a small int column (join-datagen.R
        # draws 1..100); the reference benchmark casts it to uint64
        # (the reference repository's benchmark.py:233-237)
        bv = rng.integers(1, 101, nb, dtype=np.uint64)
        pk = rng.integers(0, universe, n, dtype=np.uint64)
        cases.append(JoinCase(f"{n:.0e}-{qid}".replace("+", ""), bk, bv, pk))
    return cases


def uniform_case(n_build: int, n_probe: int, match_rate: float = 1.0,
                 seed: int = 0) -> JoinCase:
    """Uniform keys with a controlled probe match rate (bloom benchmarks:
    BASELINE.json config #3 runs 5% match)."""
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, 2**62, n_build, dtype=np.uint64)
    bv = rng.integers(0, 2**63, n_build, dtype=np.uint64)
    n_hit = int(n_probe * match_rate)
    pk = np.concatenate([
        rng.choice(bk, n_hit),
        # disjoint range => guaranteed miss
        rng.integers(2**62, 2**63, n_probe - n_hit, dtype=np.uint64),
    ])
    rng.shuffle(pk)
    return JoinCase(f"uniform_{match_rate:.0%}", bk, bv, pk)


def zipf_probe_case(n_build: int, n_probe: int, a: float = 1.2,
                    seed: int = 0, threads: int = 1) -> JoinCase:
    """Zipf-skewed probe side over the build keys (hot-key stressor for the
    distributed shuffle).  threads > 1 draws the probe side's Zipf ranks
    in that many contiguous blocks at once, each from its own generator
    spawned from the seed (numpy's draws release the interpreter lock):
    the same distribution, other draws than threads=1."""
    rng = np.random.default_rng(seed)
    # np.unique's result by a sort: numpy >= 2.3 finds unique integers
    # through a hash table, minutes at 2.5e8 distinct keys
    bk = np.sort(rng.integers(0, 2**62, n_build, dtype=np.uint64))
    first = np.ones(bk.size, bool)
    first[1:] = bk[1:] != bk[:-1]
    bk = bk[first]
    bv = rng.integers(0, 2**63, len(bk), dtype=np.uint64)
    if threads == 1:
        ranks = rng.zipf(a, size=n_probe)
    else:
        ranks = np.empty(n_probe, np.int64)
        bounds = np.linspace(0, n_probe, threads + 1).astype(np.int64)
        streams = np.random.SeedSequence(seed).spawn(threads)

        def draw(i):
            ranks[bounds[i]:bounds[i + 1]] = np.random.default_rng(
                streams[i]).zipf(a, size=bounds[i + 1] - bounds[i])
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            list(pool.map(draw, range(threads)))
    pk = bk[np.minimum(ranks - 1, len(bk) - 1)]
    return JoinCase(f"zipf_{a}", bk, bv, pk)


def dense_domain_keys(rng: np.random.Generator, n: int, lo: int,
                      n_bits: int) -> np.ndarray:
    """u64 keys that stress the dense count's domain mapping: most in the
    n_bits slots from lo, 1 % with a nonzero high word, 1 % past the
    domain's top, 1 % below lo (their u32 offset from lo wraps; 0 when lo
    is 0), and the u32-max key at rows 3 and 4."""
    keys = rng.integers(lo, lo + n_bits, n, dtype=np.uint64)
    r = rng.random(n)
    keys[r < 0.01] += np.uint64(2**32)                 # high-word rows
    keys[(r >= 0.01) & (r < 0.02)] += np.uint64(n_bits)
    below = (r >= 0.02) & (r < 0.03)
    keys[below] = rng.integers(0, max(lo, 1), int(below.sum()),
                               dtype=np.uint64)
    keys[3:5] = 2**32 - 1
    return keys


def domain_sides(rng: np.random.Generator, nb: int, npr: int, lo: int,
                 n_bits: int, below_lo: bool = True, hi_under: bool = False):
    """Build and probe keys for checking a dense-domain entry: the edge keys
    of dense_domain_keys, a third of the probes drawn from the build side.
    nb < 0: |nb| rows, every one of them bad (a high word).  Without
    below_lo the build rows below lo are raised to lo, so a scan-band lo
    (over every row) stays at lo and most build rows are in the domain.
    hi_under (with below_lo False, lo > 0): build row 0 gets a high word
    and the low word max(lo - n_bits // 2, 0), under every zero-high-word
    row's, so the scan band's lo (over every row) falls under the large
    band's (over the zero-high-word rows) and about half of the build rows
    leave the scan band's domain."""
    bk = dense_domain_keys(rng, abs(nb), lo, n_bits)
    if nb < 0:
        bk |= np.uint64(2**40)
    elif not below_lo:
        bk = np.maximum(bk, np.uint64(lo))
    if hi_under and nb > 0:
        bk[0] = 2**32 + max(lo - n_bits // 2, 0)
    pk = dense_domain_keys(rng, npr, lo, n_bits)
    if bk.size and npr:
        pk[::3] = rng.choice(bk, pk[::3].size)
    return bk, pk


def offset_plane_views(keys: np.ndarray, device, hi_off: int, lo_off: int):
    """The (hi, lo) int32 planes of u64 keys on `device`, as views that
    start hi_off / lo_off words (0-3) into longer planes: (0, 0) aligned to
    16 bytes, (1, 1) misaligned alike, (1, 3) each its own way."""
    from flash_hash_join_tpu_torch.utils.u64 import device_planes
    n = keys.size
    pad = np.zeros(3, np.uint64)
    hi = device_planes(np.concatenate([pad[:hi_off], keys, pad[hi_off:]]),
                       device)[0]
    lo = device_planes(np.concatenate([pad[:lo_off], keys, pad[lo_off:]]),
                       device)[1]
    return hi[hi_off:hi_off + n], lo[lo_off:lo_off + n]


RAGGED_KINDS = ("empty", "full", "random", "residues", "alternating",
                "out_of_range")


def ragged_counts(rng: np.random.Generator, kind: str, nblocks: int,
                  block: int) -> np.ndarray:
    """int64 counts of `nblocks` ragged blocks of `block` words (the input
    of ops/cuda/stream_compact.concat_ragged_blocks), by kind: all empty;
    all full; random in [0, block]; random with count mod 4 = block index
    mod 4, so that the running offsets take every residue; empty and full
    alternating; random with every third count negative and every third
    2^32 past it (out of range, clamped to [0, block]: only the whole int64
    word says so, its low word is in range)."""
    if kind == "empty":
        return np.zeros(nblocks, np.int64)
    if kind == "full":
        return np.full(nblocks, block, np.int64)
    idx = np.arange(nblocks)
    if kind == "alternating":
        return np.where(idx % 2, block, 0).astype(np.int64)
    counts = rng.integers(0, block + 1, nblocks)
    if kind == "residues":
        counts = counts - counts % 4 + idx % 4
        return np.where(counts > block, counts - 4, counts)
    if kind == "out_of_range":
        return np.select([idx % 3 == 0, idx % 3 == 1],
                         [-counts - 1, counts + 2**32], counts)
    if kind != "random":
        raise ValueError(f"unknown kind {kind!r}; one of {RAGGED_KINDS}")
    return counts


def _hash_u64_np(keys: np.ndarray) -> np.ndarray:
    """ops/hashing.hash_u64 of u64 keys in numpy u32 arithmetic."""
    def fmix32(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return fmix32(fmix32(lo) ^ (hi * np.uint32(0x9E3779B9)))


def _home_np(keys: np.ndarray, gbits: int, pre_shift: int = 0) -> np.ndarray:
    """The `global`-tier home group of u64 keys (ops/hash_table.home_group)."""
    h = _hash_u64_np(keys).astype(np.uint64)
    return ((h << np.uint64(pre_shift)) & np.uint64(0xFFFFFFFF)) >> \
        np.uint64(32 - gbits)


def homed_keys(rng: np.random.Generator, n: int, gbits: int, pre_shift: int,
               homes) -> np.ndarray:
    """n distinct random u64 keys whose `global`-tier home group (the top
    gbits of the hash after discarding its top pre_shift bits) is in
    `homes`, in ascending order."""
    homes = np.asarray(sorted(homes), np.uint64)
    out = np.zeros(0, np.uint64)
    while out.size < n:
        k = rng.integers(0, 2**64, 8 * n + 64, dtype=np.uint64)
        home = _home_np(k, gbits, pre_shift)
        out = np.unique(np.concatenate([out, k[np.isin(home, homes)]]))
    return np.sort(rng.permutation(out)[:n])


@dataclasses.dataclass(frozen=True)
class WalkCase:
    """An edge case of the `global` tier's walk: the columns, the table's
    configuration (a utils/config.JoinConfig), its group bits, bloom, the
    hash bits a rank discards (pre_shift) and the valid probe rows."""
    name: str
    build_keys: np.ndarray
    build_values: np.ndarray
    probe_keys: np.ndarray
    cfg: object
    gbits: int
    use_bloom: bool
    pre_shift: int = 0
    n_valid: int | None = None


def global_walk_cases(seed: int = 0) -> list[WalkCase]:
    """The walk's edge cases, bloom off and on: a crowded table (16 home
    groups of 2 slots, 3 overflow groups) whose chains cross groups and
    spill past its last group; max_probe_iters=2 binding for absent
    probes; a u64-max probe with and without a u64-max build key;
    duplicate build keys (values = build rows, so the minimum row shows);
    n_valid cut mid-array; a rank's table (pre_shift 2); an empty probe
    side; group sizes 1 and 32.  Then the edges of the walk's partition
    into table slices (ops/cuda/hash_walk.plan, forced to 1-3 digit bits on
    these small tables): chains from the last group of a slice into the
    next and from the last home group to the table's last group; every
    probe homed to one slice; Zipf-1.2 probes; u64-max probes among
    partitioned rows; n_valid cut inside a pass of 1000 rows."""
    from flash_hash_join_tpu_torch.utils.config import JoinConfig
    rng = np.random.default_rng(seed)
    m64 = np.uint64(2**64 - 1)

    def u64(n):
        return rng.integers(0, 2**64, n, dtype=np.uint64)

    def mix(*parts):
        pk = np.concatenate(parts).astype(np.uint64)
        return rng.permutation(pk)

    crowded = JoinConfig(group_size=2, overflow_groups=3)
    bk = np.concatenate([homed_keys(rng, 18, 4, 0, {13, 14, 15}),
                         homed_keys(rng, 6, 4, 0, range(8))])
    cases = [("crowded", bk, u64(bk.size),
              mix(bk, homed_keys(rng, 40, 4, 0, {13, 14, 15}), u64(200)),
              crowded, 4, 0, None)]
    iters2 = JoinConfig(group_size=2, overflow_groups=8, max_probe_iters=2)
    bk = homed_keys(rng, 16, 4, 0, {3, 4, 5})
    cases.append(("max_probe_iters_2", bk, u64(bk.size),
                  mix(bk, homed_keys(rng, 60, 4, 0, {3, 4})), iters2, 4, 0,
                  None))
    cfg = JoinConfig()
    for with_max in (True, False):
        bk = u64(300)
        if with_max:
            bk[[7, 100]] = m64
        pk = np.concatenate([[m64], bk[:50], [m64], u64(50)]).astype(np.uint64)
        cases.append((f"u64_max_{'in' if with_max else 'not_in'}_build", bk,
                      u64(300), pk, cfg, cfg.group_bits(300), 0, None))
    bk = rng.integers(0, 500, 2_000, dtype=np.uint64)
    cases.append(("duplicates", bk, np.arange(2_000, dtype=np.uint64),
                  rng.integers(0, 600, 3_000, dtype=np.uint64), cfg,
                  cfg.group_bits(2_000), 0, None))
    bk = np.concatenate([u64(1_000), [m64]]).astype(np.uint64)
    cases.append(("n_valid_cut", bk, u64(1_001), mix(bk[:900], [m64]), cfg,
                  cfg.group_bits(1_001), 0, 777))
    bk = homed_keys(rng, 800, 2, 0, {1})          # the top 2 bits: rank 1
    cases.append(("pre_shift_2", bk, u64(800),
                  mix(rng.choice(bk, 500), homed_keys(rng, 500, 2, 0, {1})),
                  cfg, cfg.group_bits(800), 2, None))
    cases.append(("empty_probe_side", bk, u64(800), np.zeros(0, np.uint64),
                  cfg, cfg.group_bits(800), 0, None))
    for g in (1, 32):
        gcfg = JoinConfig(group_size=g)
        bk = u64(5_000)
        cases.append((f"group_size_{g}", bk, u64(5_000),
                      mix(rng.choice(bk, 2_500), u64(2_500)), gcfg,
                      gcfg.group_bits(5_000), 0, None))
    bk = np.concatenate([*(homed_keys(rng, 6, 4, 0, {g})
                           for g in (1, 3, 7, 11)),
                         homed_keys(rng, 9, 4, 0, {15}),
                         homed_keys(rng, 6, 4, 0, {0, 2, 5, 9})])
    cases.append(("slice_chains", bk, u64(bk.size),
                  mix(bk, homed_keys(rng, 60, 4, 0, {1, 3, 7, 11, 15}),
                      u64(100)), crowded, 4, 0, None))
    bk = u64(5_000)
    gb = cfg.group_bits(5_000)
    near = bk[np.isin(_home_np(bk, gb), np.arange(4))]
    cases.append(("one_slice", bk, u64(5_000),
                  mix(rng.choice(near, 2_000),
                      homed_keys(rng, 1_000, gb, 0, range(4))), cfg, gb, 0,
                  None))
    bk = u64(5_000)
    ranks = np.minimum(rng.zipf(1.2, 16_000), 5_000) - 1
    cases.append(("zipf_1_2", bk, u64(5_000), mix(bk[ranks], u64(4_000)),
                  cfg, cfg.group_bits(5_000), 0, None))
    bk = u64(3_000)
    bk[5] = m64
    cases.append(("u64_max_partitioned", bk, u64(3_000),
                  mix(rng.choice(bk, 3_000), u64(1_000), [m64] * 400), cfg,
                  cfg.group_bits(3_000), 0, None))
    bk = u64(4_000)
    cases.append(("n_valid_pass_cut", bk, u64(4_000),
                  mix(rng.choice(bk, 3_000), u64(2_000)), cfg,
                  cfg.group_bits(4_000), 0, 3_333))
    return [WalkCase(name + ("_bloom" if bloom else ""), bk, bv, pk, c, gb,
                     bloom, shift, nv)
            for name, bk, bv, pk, c, gb, shift, nv in cases
            for bloom in (False, True)]


@dataclasses.dataclass(frozen=True)
class BuildCase:
    """An edge case of the `global` tier's table build: the build columns,
    the table's configuration (a utils/config.JoinConfig: group size,
    overflow groups, bloom_k), its group bits, bloom, the hash bits a rank
    discards (pre_shift), the valid rows (None: all) and the probe bound
    (build_table's max_probe_iters; None: none)."""
    name: str
    build_keys: np.ndarray
    build_values: np.ndarray
    cfg: object
    gbits: int
    use_bloom: bool
    pre_shift: int = 0
    n_valid: int | None = None
    max_probe_iters: int | None = None

    def build_kwargs(self) -> dict:
        """ops/hash_table.build_table's keywords for this case."""
        return dict(gbits=self.gbits, group_size=self.cfg.group_size,
                    overflow_groups=self.cfg.overflow_groups,
                    with_bloom=self.use_bloom, bloom_k=self.cfg.bloom_k,
                    pre_shift=self.pre_shift,
                    max_probe_iters=self.max_probe_iters)

    def valid_rows(self) -> int:
        n = self.build_keys.size
        return n if self.n_valid is None else self.n_valid


def global_build_cases(seed: int = 0) -> list[BuildCase]:
    """The build's edge cases, bloom off and on: random keys; duplicates
    whose values are their build rows (so the minimum row shows); all keys
    equal (one group of 3000 rows, past one 2048-row sorting chunk of the
    build kernel); 3000 distinct keys homed to one group, a third of them
    repeated (a large group with duplicates); u64-max keys, repeated and
    alone; n_valid cut mid-array and 0; an empty side; global_walk_cases'
    crowded table, which drops rows past its last group; max_probe_iters=2,
    whose long chains count as dropped but are written; pre_shift 1-3 (a
    rank's keys); group sizes 1, 2, 8 and 32.  Then the edges of the build
    kernel's tiles (ops/cuda/hash_build.plan: 2^12 groups of few rows make
    8 tiles of 2^9 groups): a chain from the last group of tile 0 into the
    groups of tile 1, which hold rows of their own; the last tile's chain
    through the overflow groups and past them; 1 group bit for 5000 rows,
    fewer than the rows would partition by (tiles of one group, past the
    2048 rows a tile holds in shared memory); pre_shift 1-3 over 2^18
    groups (two partition levels); a tile whose rows are all u64-max."""
    from flash_hash_join_tpu_torch.utils.config import JoinConfig
    rng = np.random.default_rng(seed)
    m64 = np.uint64(2**64 - 1)

    def u64(n):
        return rng.integers(0, 2**64, n, dtype=np.uint64)

    def rows(n):
        return np.arange(n, dtype=np.uint64)

    cfg = JoinConfig()
    cases = [("random", u64(3_000), u64(3_000), cfg, cfg.group_bits(3_000),
              0, None, None)]
    bk = rng.integers(0, 500, 2_000, dtype=np.uint64)
    cases.append(("duplicates", bk, rows(bk.size), cfg, cfg.group_bits(2_000),
                  0, None, cfg.max_probe_iters))
    cases.append(("all_equal", np.full(3_000, 12345, np.uint64), rows(3_000),
                  cfg, cfg.group_bits(3_000), 0, None, cfg.max_probe_iters))
    one = homed_keys(rng, 3_000, 4, 0, {5})
    bk = rng.permutation(np.concatenate([one, one[::3]]))
    cases.append(("one_large_group", bk, rows(bk.size),
                  JoinConfig(group_size=32, overflow_groups=200), 4, 0, None,
                  50))
    bk = u64(300)
    bk[[7, 100, 201]] = m64
    cases.append(("u64_max_repeated", bk, u64(300), cfg, cfg.group_bits(300),
                  0, None, None))
    bk = u64(300)
    bk[150] = m64
    cases.append(("u64_max_alone", bk, u64(300), cfg, cfg.group_bits(300), 0,
                  None, None))
    bk = np.concatenate([u64(1_000), [m64]]).astype(np.uint64)
    bk[800:900] = bk[700:800]                  # duplicates across the cut
    cases.append(("n_valid_cut", bk, rows(bk.size), cfg,
                  cfg.group_bits(bk.size), 0, 777, None))
    cases.append(("n_valid_0", u64(100), u64(100), cfg, cfg.group_bits(100),
                  0, 0, None))
    cases.append(("empty", np.zeros(0, np.uint64), np.zeros(0, np.uint64),
                  cfg, cfg.group_bits(0), 0, None, None))
    crowded = JoinConfig(group_size=2, overflow_groups=3)
    bk = np.concatenate([homed_keys(rng, 18, 4, 0, {13, 14, 15}),
                         homed_keys(rng, 6, 4, 0, range(8))])
    cases.append(("crowded", rng.permutation(bk), u64(bk.size), crowded, 4,
                  0, None, None))
    iters2 = JoinConfig(group_size=2, overflow_groups=8, max_probe_iters=2)
    bk = homed_keys(rng, 16, 4, 0, {3, 4, 5})
    cases.append(("max_probe_iters_2", rng.permutation(bk), u64(bk.size),
                  iters2, 4, 0, None, 2))
    for shift in (1, 2, 3):
        bk = homed_keys(rng, 800, shift, 0, {1})  # the top bits of rank 1
        cases.append((f"pre_shift_{shift}", rng.permutation(bk), u64(800),
                      cfg, cfg.group_bits(800), shift, None,
                      cfg.max_probe_iters))
    for g in (1, 2, 8, 32):
        gcfg = JoinConfig(group_size=g)
        cases.append((f"group_size_{g}", u64(3_000), u64(3_000), gcfg,
                      gcfg.group_bits(3_000), 0, None, gcfg.max_probe_iters))
    tiles = JoinConfig(group_size=2, overflow_groups=8)
    pool = np.unique(u64(1 << 20))
    home12 = _hash_u64_np(pool) >> np.uint32(20)

    def homed12(n, homes):   # n keys of the pool homed to `homes` of 2^12
        return rng.permutation(pool[np.isin(home12, list(homes))])[:n]

    bk = np.concatenate([homed12(40, {511}), homed12(12, {512, 513, 520}),
                         u64(300)])
    cases.append(("tile_boundary_chain", rng.permutation(bk), u64(bk.size),
                  tiles, 12, 0, None, None))
    bk = np.concatenate([homed12(30, {4095}), homed12(6, {4094}), u64(300)])
    cases.append(("tile_into_overflow", rng.permutation(bk), u64(bk.size),
                  tiles, 12, 0, None, None))
    cases.append(("gbits_below_partition", u64(5_000), u64(5_000),
                  JoinConfig(group_size=32, overflow_groups=200), 1, 0, None,
                  None))
    for shift in (1, 2, 3):
        bk = homed_keys(rng, 2_000, shift, 0, {1})
        cases.append((f"pre_shift_{shift}_two_levels", rng.permutation(bk),
                      u64(2_000), cfg, 18, shift, None, cfg.max_probe_iters))
    max_tile = int(_hash_u64_np(np.array([m64]))[0]) >> 29  # top 3 of 12
    bk = np.concatenate([np.full(700, m64),
                         homed_keys(rng, 300, 3, 0,
                                    set(range(8)) - {max_tile})])
    cases.append(("u64_max_tile", rng.permutation(bk), u64(bk.size), tiles,
                  12, 0, None, None))
    return [BuildCase(name + ("_bloom" if bloom else ""), bk, bv, c, gb,
                      bloom, shift, nv, it)
            for name, bk, bv, c, gb, shift, nv, it in cases
            for bloom in (False, True)]


@dataclasses.dataclass(frozen=True)
class RangeBuildCase:
    """An edge case of the partitioned tier's table build: the build
    columns and the valid rows (a prefix of them)."""
    name: str
    build_keys: np.ndarray
    build_values: np.ndarray
    nb_valid: int


def range_build_cases(seed: int = 0) -> list[RangeBuildCase]:
    """The table build's edge cases (ops/cuda/range_build.py), a few
    thousand rows each: a J1 draw at this size (join-datagen.R's
    permutation of 1..1.1n) and 20,000 keys drawn over J1 1e8's 1..1.1e8
    (27 bits), each with one u64-max key among them too; duplicates whose
    values are their rows (so the minimum row shows); 2,000 equal keys
    among 20,000; keys over all 64 bits; high words all at or above 2^31
    (negative int32 patterns); keys 2^32 - 8 .. 2^32 + 8 across the high
    word's boundary; keys whose low two digits never vary, and keys that
    vary in the high word alone (digits skipped below and above a sorted
    one); all keys equal; valid rows cut short of the planes, the tail
    holding keys that would sort first; 0, 1, 256 and 257 valid rows; and
    the edges of the card's tiles (4096 rows, 6144 for a narrow key
    alone)."""
    rng = np.random.default_rng(seed)
    m64 = np.uint64(2**64 - 1)

    def u64(n, lo=0, hi=2**64):
        return rng.integers(lo, hi, n, dtype=np.uint64)

    def with_max(bk):
        bk = bk.copy()
        bk[bk.size // 2] = m64
        return bk

    j1 = rng.permutation(np.arange(1, 22_001, dtype=np.uint64))[:20_000]
    j1e8 = u64(20_000, 1, 110_000_001)
    dup = u64(5_000, 0, 500)
    equal = u64(20_000, 1, 110_000_001)
    equal[rng.choice(equal.size, 2_000, replace=False)] = 77_777_777
    cut = u64(6_000, 1_000, 2**40)
    cut[5_000:] = 0
    keys = {
        "j1": j1, "j1_u64_max": with_max(j1),
        "j1_1e8_range": j1e8, "j1_1e8_range_u64_max": with_max(j1e8),
        "duplicates": dup, "equal_2e3_in_2e4": equal,
        "full_range": u64(20_000), "high_words_negative": u64(20_000, 2**63),
        "word_boundary": u64(20_000, 2**32 - 8, 2**32 + 9),
        "low_digits_fixed": u64(20_000, 0, 2**24) << np.uint64(16),
        "high_word_only": u64(20_000, 0, 2**20) << np.uint64(40),
        "all_equal": np.full(5_000, 123_456_789_012, np.uint64),
        "valid_cut": cut,
    }
    cases = [RangeBuildCase(name, bk, np.arange(bk.size, dtype=np.uint64)
                            if name == "duplicates" else u64(bk.size),
                            5_000 if name == "valid_cut" else bk.size)
             for name, bk in keys.items()]
    for nb in (0, 1, 256, 257, 4_095, 4_096, 4_097, 6_144, 12_289):
        bk = u64(nb + 3, 0, 2**36)
        cases.append(RangeBuildCase(f"rows_{nb}", bk, u64(bk.size), nb))
    return cases


@dataclasses.dataclass(frozen=True)
class RangeProbeCase:
    """A case of K4's two routes (ops/cuda/range_probe.py): the build side,
    the probe keys, the valid probe rows and the valid rows a pass."""
    name: str
    build_keys: np.ndarray
    build_values: np.ndarray
    probe_keys: np.ndarray
    np_valid: int
    pass_rows: int | None = None


def range_probe_cases(seed: int = 0) -> list[RangeProbeCase]:
    """K4's sliced route's edge cases, a few tens of thousands of rows each:
    a J1 draw (join-datagen.R's permutation of 1..1.1n, 90 % of the probes
    matching); one far outlier whose span puts nearly every key in bucket 0;
    probes all below the least key or above the greatest; duplicate runs
    whose values are their rows (so the minimum row shows); the u64-max key
    on both sides; valid probe rows cut short of the planes; passes of 1,000
    rows; and a build of SMALL_TABLE + 1 keys, the least with a directory."""
    rng = np.random.default_rng(seed)
    m64 = np.uint64(2**64 - 1)

    def u64(n, lo=0, hi=2**64):
        return rng.integers(lo, hi, n, dtype=np.uint64)

    def mixed(bk, n):
        """n probes: build keys, their neighbours (misses inside buckets)
        and random keys."""
        near = rng.choice(bk, n // 4)
        return rng.permutation(np.concatenate([
            rng.choice(bk, n // 2), near + np.uint64(1),
            u64(n - n // 2 - n // 4)]))

    perm = rng.permutation(np.arange(1, 33_001, dtype=np.uint64))
    j1_build = perm[:30_000]
    j1_probe = rng.permutation(np.concatenate([perm[:27_000],
                                               perm[30_000:33_000]]))
    outlier = u64(20_000, 0, 10**6)
    outlier[7] = np.uint64(2**63)
    lo_hi = u64(20_000, 2**40, 2**41)
    outside = np.concatenate([u64(15_000, 0, 2**40),
                              u64(15_000, 2**41, 2**64)])
    dup = u64(20_000, 0, 3_000)
    with_max = u64(20_000, 0, 2**40)
    with_max[[3, 11]] = m64
    max_probe = mixed(with_max, 30_000)
    max_probe[::97] = m64
    cut = u64(20_000)
    small = u64(257)
    cases = [
        RangeProbeCase("j1", j1_build, u64(j1_build.size), j1_probe,
                       j1_probe.size),
        RangeProbeCase("far_outlier", outlier, u64(outlier.size),
                       mixed(outlier, 30_000), 30_000),
        RangeProbeCase("all_outside", lo_hi, u64(lo_hi.size), outside,
                       outside.size),
        RangeProbeCase("duplicates", dup, np.arange(dup.size, dtype=np.uint64),
                       mixed(dup, 30_000), 30_000),
        RangeProbeCase("u64_max", with_max, u64(with_max.size), max_probe,
                       max_probe.size),
        RangeProbeCase("np_valid_cut", cut, u64(cut.size), mixed(cut, 30_000),
                       21_001),
        RangeProbeCase("passes_of_1000", cut, u64(cut.size),
                       mixed(cut, 30_000), 29_999, pass_rows=1_000),
        RangeProbeCase("small_table_plus_one", small, u64(small.size),
                       mixed(small, 30_000), 30_000),
    ]
    return cases

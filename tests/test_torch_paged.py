"""The port's paged KV pool and copy-on-write prefix reuse against the JAX
package's (``repro.serving`` with ``page_size=...``).

Both engines serve the same requests over weights made on the JAX side and
carried across (fp32, ``serve-w8a16`` over the fp cache and
``serve-w8a8-kv8`` over the int8 cache): tokens, admission and finish
ticks, statuses and counters must equal the JAX paged engine's, fast and
stepwise, and equal the port's contiguous engine's. With prefix reuse on,
the index's hits, ``cow_copies`` and the prefill chunks must be JAX's too.
Below the engine: the gather into the dense view and the commit of the
written window against ``repro.serving.engine._paged_view`` /
``_paged_commit`` on arrays carried across; the pool's page tables,
refcounts, free-heap order, slot pages and ``cow_copies`` equal to the JAX
pool's after every operation of seeded random sequences; the audit
catching planted corruption; ``bytes_per_slot`` in both layouts; and
``PrefixIndex`` against JAX's. Everything runs on the port's plain
versions on the CPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.serving import CachePool as JaxCachePool
from repro.serving import PrefixIndex as JaxPrefixIndex
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.cache_pool import PoolExhausted as JaxPoolExhausted
from repro.serving.engine import _paged_commit as jax_paged_commit
from repro.serving.engine import _paged_view as jax_paged_view

from repro_torch.serving import (
    CachePool,
    PoolExhausted,
    PrefixIndex,
    Request,
    RequestTooLarge,
    ServingEngine,
)
from repro_torch.serving.engine import _paged_commit, _paged_view

from _torch_port import serving_pair

VARIANTS = ["fp32", "serve-w8a16", "serve-w8a8-kv8"]
# the JAX paged tests' engine: 2 slots for 4 requests (slot recycling)
ENGINE = dict(num_slots=2, max_len=32, prefill_chunk=8)
COUNTERS = ("decode_steps", "decode_dispatches", "prefill_chunks",
            "prefill_dispatches", "host_syncs", "generated_tokens",
            "engine_steps", "preempted", "resumed", "shed", "cancelled",
            "expired", "quarantined")


@pytest.fixture(scope="module", params=VARIANTS)
def pair(request):
    return serving_pair(request.param)


@pytest.fixture(scope="module")
def fp32():
    return serving_pair("fp32")


def _mixed(vocab):
    """The JAX paged tests' trace (a gen-at-prefill request included)."""
    rng = np.random.RandomState(7)
    lens = [(5, 6), (12, 3), (3, 1), (9, 8)]
    return [(i, rng.randint(0, vocab, size=p).astype(np.int32), g, 0.0)
            for i, (p, g) in enumerate(lens)]


def _shared_prefix(vocab):
    """Requests sharing a 16-token prefix, staggered so later ones find it
    published: rid 1 (prompt = the first page) and rid 3 (the first two
    pages) split a page at their chunk-aligned reuse length — a
    copy-on-write each — and rid 2 maps both pages whole."""
    rng = np.random.RandomState(11)
    base = rng.randint(0, vocab, size=16).astype(np.int32)
    tail = rng.randint(0, vocab, size=8).astype(np.int32)
    return [(0, np.concatenate([base, tail[:3]]), 4, 0.0),
            (1, base[:8], 4, 6.0),
            (2, np.concatenate([base, tail[3:8]]), 5, 7.0),
            (3, base[:16], 3, 8.0)]


def _requests(cls, spec):
    return [cls(rid=rid, prompt=prompt, max_new_tokens=g, arrival=a)
            for rid, prompt, g, a in spec]


def _jax_engine(jax_side, **kw):
    jm, jp, jcfg = jax_side
    return JaxServingEngine(jm, jp, jcfg, **kw)


def _engine(torch_side, kv_bits, **kw):
    model, params, cfg = torch_side
    return ServingEngine(model, params, cfg, device="cpu", kv_bits=kv_bits,
                         **kw)


def _assert_same(res, jres, what):
    assert sorted(res) == sorted(jres), what
    for rid in jres:
        got, want = res[rid], jres[rid]
        assert got.tokens == [int(t) for t in want.tokens], (what, rid)
        assert got.admitted_at == want.admitted_at, (what, rid)
        assert got.finished_at == want.finished_at, (what, rid)
        assert got.status == want.status, (what, rid)


def _assert_same_stats(eng, jeng, what):
    for k in COUNTERS:
        assert eng.stats[k] == jeng.stats[k], (what, k)


# ------------------------------------------------------- layout parity

@pytest.mark.parametrize("fast", [True, False])
def test_paged_matches_jax_and_contiguous(pair, fast):
    """Reuse off: the paged engine equals the JAX paged engine (tokens,
    ticks, statuses, counters) and the port's contiguous engine (tokens and
    ticks), through slot recycling and a gen-at-prefill request."""
    jax_side, torch_side, kv_bits = pair
    spec = _mixed(torch_side[2].vocab_size)
    jeng = _jax_engine(jax_side, fast=fast, page_size=8, prefix_reuse=False,
                       **ENGINE)
    jres = jeng.run(_requests(JaxRequest, spec))
    eng = _engine(torch_side, kv_bits, fast=fast, page_size=8,
                  prefix_reuse=False, **ENGINE)
    res = eng.run(_requests(Request, spec))
    _assert_same(res, jres, "paged vs JAX paged")
    _assert_same_stats(eng, jeng, "paged vs JAX paged")
    flat = _engine(torch_side, kv_bits, fast=fast, **ENGINE).run(
        _requests(Request, spec))
    _assert_same(res, flat, "paged vs contiguous")
    assert eng.pool.all_free() and eng.pool.n_free_pages == eng.pool.num_pages
    eng.check_invariants()


def test_prefix_reuse_matches_jax(pair):
    """Reuse on, over a shared-prefix trace: the JAX paged engine's tokens,
    ticks, index hits, ``cow_copies`` and prefill chunks, fast and
    stepwise; the tokens of the contiguous engine, no request later."""
    jax_side, torch_side, kv_bits = pair
    spec = _shared_prefix(torch_side[2].vocab_size)
    kw = dict(ENGINE, prefill_chunk=4, page_size=8)
    jeng = _jax_engine(jax_side, **kw)
    jres = jeng.run(_requests(JaxRequest, spec))
    flat = _engine(torch_side, kv_bits, **dict(ENGINE, prefill_chunk=4)).run(
        _requests(Request, spec))
    for fast in (True, False):
        eng = _engine(torch_side, kv_bits, fast=fast, **kw)
        res = eng.run(_requests(Request, spec))
        _assert_same(res, jres, f"reuse fast={fast}")
        assert eng.prefix_index.hits == jeng.prefix_index.hits
        assert eng.prefix_index.misses == jeng.prefix_index.misses
        assert eng.pool.cow_copies == jeng.pool.cow_copies >= 2
        assert eng.stats["prefill_chunks"] == jeng.stats["prefill_chunks"]
        assert list(eng.pool._free_pages) == list(jeng.pool._free_pages)
        assert eng.pool._page_ref == jeng.pool._page_ref
        for rid, r in flat.items():
            assert res[rid].tokens == r.tokens, rid
            assert res[rid].finished_at <= r.finished_at, rid
        assert res[3].finished_at < flat[3].finished_at
        eng.check_invariants()
    assert eng.stats["prefill_chunks"] < sum(
        -(-len(p) // 4) for _, p, _, _ in spec)


def test_tight_page_pool_blocks_then_recovers(fp32):
    """A pool below full capacity: admission blocks head-of-line on pages
    (after evicting index entries) and every request still gets the
    contiguous tokens, at JAX's ticks."""
    jax_side, torch_side, kv_bits = fp32
    spec = _mixed(torch_side[2].vocab_size)
    jeng = _jax_engine(jax_side, page_size=8, num_pages=6, **ENGINE)
    jres = jeng.run(_requests(JaxRequest, spec))
    eng = _engine(torch_side, kv_bits, page_size=8, num_pages=6, **ENGINE)
    res = eng.run(_requests(Request, spec))
    _assert_same(res, jres, "tight pool")
    assert eng.prefix_index.evictions == jeng.prefix_index.evictions
    assert eng.pool.all_free()


def test_paged_submit_rejects_unservable_request(fp32):
    _, torch_side, kv_bits = fp32
    eng = _engine(torch_side, kv_bits, page_size=8, num_pages=2, **ENGINE)
    with pytest.raises(RequestTooLarge, match="pages"):
        eng.submit(Request(rid=0, prompt=[1] * 20, max_new_tokens=2))
    eng.submit(Request(rid=1, prompt=[1] * 9, max_new_tokens=2))


# ------------------------------------------------- gather and commit

def _filled_pools(fp32, kv_bits, seed):
    """A JAX and a port paged pool (3 slots, ring 24, page 8, 12 pages)
    with the same random payload and a page table of unique pages with
    unmapped entries."""
    jax_side, torch_side, _ = fp32
    kw = dict(page_size=8, num_pages=12, kv_bits=kv_bits)
    jpool = JaxCachePool(jax_side[0], 3, 24, **kw)
    pool = CachePool(torch_side[0], 3, 24, device="cpu", **kw)
    rng = np.random.RandomState(seed)
    jcache = dict(jpool.cache)
    for name, leaf in pool.cache.items():
        if name in ("kpos", "pos", "page_table"):
            continue
        if leaf.dtype == torch.int8:
            vals = rng.randint(-127, 128, size=tuple(leaf.shape)).astype(np.int8)
        else:
            vals = rng.randn(*leaf.shape).astype(np.float32)
        leaf.copy_(torch.from_numpy(vals))
        jcache[name] = jnp.asarray(vals).astype(jcache[name].dtype)
    table = np.full((3, 3), -1, np.int32)
    perm = rng.permutation(12)
    table[0] = perm[:3]
    table[1, :2] = perm[3:5]
    table[2, :1] = perm[5:6]
    pool.cache["page_table"].copy_(torch.from_numpy(table.astype(np.int64)))
    jcache["page_table"] = jnp.asarray(table)
    jpool.cache = jcache
    return jpool, pool, rng


@pytest.mark.parametrize("kv_bits", [8, 16])
def test_gather_and_commit_match_jax(fp32, kv_bits):
    """``_paged_view`` gathers JAX's dense view (unmapped entries read
    page 0) and ``_paged_commit`` writes JAX's pages: written rows land in
    their pages, rows of -1 and positions on unmapped pages are dropped
    (the port sends them to the sink page, outside ``pool.cache``)."""
    jpool, pool, rng = _filled_pools(fp32, kv_bits, seed=kv_bits)
    jdense = jax_paged_view(jpool.cache, 8, 24)
    dense = {name: torch.zeros((store.shape[0], 3, 24) + tuple(store.shape[3:]),
                               dtype=store.dtype)
             for name, store in pool.storage.items()}
    _paged_view(pool, dense)
    for name, leaf in dense.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jdense[name]),
                                      err_msg=name)
    # new values in the view, then a write window: slot 0 writes 5
    # positions across a page boundary, slot 1 writes two of them onto its
    # unmapped third page, slot 2 writes nothing
    for name, leaf in dense.items():
        if leaf.dtype == torch.int8:
            vals = rng.randint(-127, 128, size=tuple(leaf.shape)).astype(np.int8)
        else:
            vals = rng.randn(*leaf.shape).astype(np.float32)
        leaf.copy_(torch.from_numpy(vals))
        jdense[name] = jnp.asarray(vals).astype(jdense[name].dtype)
    rows = np.array([[6, 7, 8, 9, 10], [14, 15, 16, 17, -1],
                     [-1, -1, -1, -1, -1]], np.int32)
    jout = jax_paged_commit(jpool.cache, jdense, jnp.asarray(rows), 8)
    before = {k: v.clone() for k, v in pool.storage.items()}
    _paged_commit(pool, dense, torch.from_numpy(rows.astype(np.int64)))
    for name, store in pool.storage.items():
        np.testing.assert_array_equal(pool.cache[name].numpy(),
                                      np.asarray(jout[name]), err_msg=name)
        assert not torch.equal(store[:, :12], before[name][:, :12]), name
    assert pool.cache_bytes() == jpool.cache_bytes()


# ---------------------------------------------- pool bookkeeping vs JAX

def _pool_state(pool):
    table = np.asarray(pool.cache["page_table"]).astype(np.int64)
    kpos = np.asarray(pool.cache["kpos"]).astype(np.int64)
    pos = np.asarray(pool.cache["pos"]).astype(np.int64)
    payload = {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
               for k, v in pool.cache.items()
               if k not in ("kpos", "pos", "page_table")}
    return dict(table=table, kpos=kpos, pos=pos, payload=payload,
                free_pages=list(pool._free_pages),
                ref=list(pool._page_ref),
                slot_pages={s: list(p) for s, p in pool._slot_pages.items()},
                free=sorted(pool._free), cow=pool.cow_copies,
                reserved=sorted(pool._reserved))


@pytest.mark.parametrize("seed", range(5))
def test_pool_operations_match_jax(fp32, seed):
    """Seeded random allocate (with shared pages and a split reuse) / COW /
    release / pin / unpin / reserve / return sequences on a JAX and a port
    pool: after every operation the page table, kpos / pos, every page's
    bytes, the free heap in its order, refcounts, slot pages, the free
    slots, reservations and ``cow_copies`` are equal, as are the
    ``PoolExhausted`` refusals; the audit holds throughout."""
    jpool, pool, rng = _filled_pools(fp32, 8, seed=100 + seed)
    jpool.cache = {**jpool.cache,
                   "page_table": jnp.full((3, 3), -1, jnp.int32)}
    pool.cache["page_table"].fill_(-1)
    slots, pins, reserved = {}, [], []

    def both(fn_port, fn_jax):
        try:
            a = fn_port()
        except PoolExhausted:
            a = "exhausted"
        try:
            b = fn_jax()
        except JaxPoolExhausted:
            b = "exhausted"
        assert a == b
        return a

    for _ in range(40):
        op = rng.randint(0, 6)
        if op == 0 and len(slots) < 3:
            need = int(rng.randint(1, 25))
            shared, reuse = [], 0
            if pins and rng.rand() < 0.6:
                reuse = int(rng.choice([4, 8]))
                shared = [pins[0]]
                need = max(need, reuse + 1)
            s = both(lambda: pool.allocate_pages(need, shared, reuse),
                     lambda: jpool.allocate_pages(need, shared, reuse))
            if s != "exhausted":
                slots[s] = need
        elif op == 1 and slots:
            s = sorted(slots)[rng.randint(len(slots))]
            start = int(rng.randint(0, slots[s]))
            stop = min(slots[s], start + 8)
            both(lambda: pool.ensure_writable(s, start, stop),
                 lambda: jpool.ensure_writable(s, start, stop))
        elif op == 2 and slots:
            s = sorted(slots)[rng.randint(len(slots))]
            pool.release(s)
            jpool.release(s)
            del slots[s]
        elif op == 3 and slots:
            s = sorted(slots)[rng.randint(len(slots))]
            pages = pool.slot_pages(s)
            p = pages[rng.randint(len(pages))]
            pool.ref_page(p)
            jpool.ref_page(p)
            pins.append(p)
        elif op == 4 and pins:
            p = pins.pop(rng.randint(len(pins)))
            pool.deref_page(p)
            jpool.deref_page(p)
        elif op == 5:
            if reserved and rng.rand() < 0.5:
                got = reserved.pop()
                pool.release_reserved(got)
                jpool.release_reserved(got)
            else:
                n = int(rng.randint(1, 4))
                got = pool.reserve_pages(n)
                assert got == jpool.reserve_pages(n)
                if got:
                    reserved.append(got)
        a, b = _pool_state(pool), _pool_state(jpool)
        for key in ("table", "kpos", "pos"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        for name in a["payload"]:
            np.testing.assert_array_equal(a["payload"][name],
                                          b["payload"][name], err_msg=name)
        for key in ("free_pages", "ref", "slot_pages", "free", "cow",
                    "reserved"):
            assert a[key] == b[key], key
        ext = {}
        for p in pins:
            ext[p] = ext.get(p, 0) + 1
        pool.check_invariants(external_refs=ext)


def test_allocate_pages_validates_arguments(fp32):
    _, torch_side, _ = fp32
    pool = CachePool(torch_side[0], 2, 32, device="cpu", page_size=8)
    with pytest.raises(RuntimeError, match="allocate_pages"):
        pool.allocate()
    with pytest.raises(ValueError, match="reuse_len"):
        pool.allocate_pages(8, reuse_len=8)
    with pytest.raises(ValueError, match="shared pages"):
        pool.allocate_pages(16, shared=[], reuse_len=8)
    with pytest.raises(ValueError, match="slot table"):
        pool.allocate_pages(40)
    flat = CachePool(torch_side[0], 2, 32, device="cpu")
    with pytest.raises(RuntimeError, match="paged pool"):
        flat.allocate_pages(8)


def test_paged_pool_exhaustion_is_atomic(fp32):
    _, torch_side, _ = fp32
    pool = CachePool(torch_side[0], 3, 32, device="cpu", page_size=8,
                     num_pages=5)
    s = pool.allocate_pages(24)
    before = (list(pool._free_pages), list(pool._page_ref), set(pool._free),
              pool.cache["page_table"].clone(), pool.cache["kpos"].clone())
    with pytest.raises(PoolExhausted, match="fresh pages"):
        pool.allocate_pages(24)
    after = (list(pool._free_pages), list(pool._page_ref), set(pool._free))
    assert after == before[:3]
    assert torch.equal(pool.cache["page_table"], before[3])
    assert torch.equal(pool.cache["kpos"], before[4])
    pool.release(s)
    pool.check_invariants()
    assert pool.n_free_pages == 5


# -------------------------------------------------------- the audit

def _corrupt_phantom_ref(pool, s):
    pool._page_ref[pool.slot_page(s, 0)] += 1


def _corrupt_free_twice(pool, s):
    pool._free_pages.append(pool._free_pages[0])


def _corrupt_maps_freed_page(pool, s):
    pool._slot_pages[s][0] = pool._free_pages[0]


def _corrupt_slot_both(pool, s):
    pool._free.add(s)


@pytest.mark.parametrize("corrupt", [_corrupt_phantom_ref, _corrupt_free_twice,
                                     _corrupt_maps_freed_page,
                                     _corrupt_slot_both])
def test_check_invariants_catches_corruption(fp32, corrupt):
    """The audit trips on planted corruption, and only then."""
    _, torch_side, _ = fp32
    pool = CachePool(torch_side[0], 2, 32, device="cpu", page_size=8)
    s = pool.allocate_pages(need=9)
    pool.check_invariants()
    corrupt(pool, s)
    with pytest.raises(AssertionError):
        pool.check_invariants()


# ------------------------------------------------------------- bytes

@pytest.mark.parametrize("kv_bits", [8, 16])
@pytest.mark.parametrize("page_size", [None, 8])
def test_bytes_match_jax(fp32, kv_bits, page_size):
    """``cache_bytes`` and ``bytes_per_slot`` are the JAX pool's in both
    layouts (the sink page is not counted), and a full-capacity paged pool
    holds a contiguous pool's bytes a slot."""
    jax_side, torch_side, _ = fp32
    kw = dict(kv_bits=kv_bits, page_size=page_size)
    jpool = JaxCachePool(jax_side[0], 3, 32, **kw)
    pool = CachePool(torch_side[0], 3, 32, device="cpu", **kw)
    assert pool.cache_bytes() == jpool.cache_bytes()
    assert pool.bytes_per_slot() == jpool.bytes_per_slot()
    flat = CachePool(torch_side[0], 3, 32, device="cpu", kv_bits=kv_bits)
    assert pool.bytes_per_slot() == flat.bytes_per_slot()
    if page_size:
        for name, store in pool.storage.items():
            assert store.shape[1] == pool.num_pages + 1
            assert pool.cache[name].data_ptr() == store.data_ptr()


# ------------------------------------------------------------ PrefixIndex

class _FakePool:
    def __init__(self, pages):
        self.pages, self.refs = pages, {}

    def slot_page(self, slot, idx):
        return self.pages[idx]

    def ref_page(self, p):
        self.refs[p] = self.refs.get(p, 0) + 1

    def deref_page(self, p):
        self.refs[p] -= 1


def test_prefix_index_matches_jax():
    """Publish (full pages only, the first donor wins), lookup (the
    longest page-aligned prefix, LRU touch), eviction with a protected set,
    clear, and the counters — as JAX's index."""
    rng = np.random.RandomState(5)
    a = list(rng.randint(0, 50, size=20))
    b = a[:8] + list(rng.randint(50, 99, size=9))
    out = []
    for cls in (PrefixIndex, JaxPrefixIndex):
        idx, pool = cls(4), _FakePool([10, 11, 12, 13, 14])
        log = [idx.publish(a, pool, 0), idx.publish(b, pool, 1),
               idx.lookup(a[:10]), idx.lookup(b), idx.lookup([99] * 8),
               idx.lookup(a[:3]), len(idx), idx.pages()]
        log.append(idx.evict_lru(pool, protect={10, 11}))
        log.append(idx.pages())
        idx.clear(pool)
        log += [len(idx), dict(pool.refs), idx.hits, idx.misses,
                idx.evictions]
        out.append(log)
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        PrefixIndex(0)


@pytest.mark.parametrize("page_size", [3, 6])
def test_page_size_off_the_ring_matches_jax(fp32, page_size):
    """Pages that do not divide the ring (the last page of a table partly
    past it), reuse on over the shared-prefix trace: JAX's tokens, ticks,
    hits and copies, fast and stepwise."""
    jax_side, torch_side, kv_bits = fp32
    spec = _shared_prefix(torch_side[2].vocab_size)
    kw = dict(ENGINE, prefill_chunk=4, page_size=page_size)
    jeng = _jax_engine(jax_side, **kw)
    jres = jeng.run(_requests(JaxRequest, spec))
    for fast in (True, False):
        eng = _engine(torch_side, kv_bits, fast=fast, **kw)
        _assert_same(eng.run(_requests(Request, spec)), jres,
                     f"page {page_size} fast={fast}")
        assert eng.pool.pages_per_slot * page_size > eng.max_len
        assert eng.prefix_index.hits == jeng.prefix_index.hits
        assert eng.pool.cow_copies == jeng.pool.cow_copies
        eng.check_invariants()

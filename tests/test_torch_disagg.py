"""Port disaggregated tiers (``paddle_tpu_torch.inference.disagg``) against
the JAX package's, on carried tiny-Llama weights (fp32, CPU).

Chain functions: ``gather_chain_pages`` / ``gather_chain_scales`` give the
JAX functions' bytes from the same pool bytes (fp32 and int8), and
``scatter_chain_pages`` writes them back in place (an int8 pool without
scales raises before any write). The ``corrupt`` hook damages the same
bytes as JAX's under the same plan.

Codec (PTKV1): an exported chain spliced into a fresh engine continues the
uninterrupted stream byte for byte (greedy and seeded); export leaves the
source untouched until ``withdraw_active``; a flipped page byte, a forged
header field and a truncation raise PT-SRV-007 with the destination's
free blocks, free slots and radix untouched; a shortfall raises
``EngineSaturated``, another geometry ``ValueError``. Across packages the
artifacts are one format: a JAX chain continues in the port to JAX's
greedy stream and a port chain in JAX to the port's, and an import
followed at once by a re-export gives the same bytes, both ways.

``TieredRouter``: a prefixless tier is refused at construction, an
incompatible decode tier decodes in place, tiered == single engine byte
for byte (greedy and seeded; cold, warm and through copy-on-write), the
tiered greedy streams equal the JAX single engine's, a decode-replica kill
after splices replays exactly with nothing served twice, and the journals
(``migr-kv`` on the prefill side, admit/prog on the decode side) load in
both packages with the same ``pending()`` set. Spec decode tiers:
``_spec_seed(extra=)`` lays prompt + delivered tokens into the ring as
JAX's, and a migrated spec stream equals JAX's with the same drafter
acceptance counts (the ring re-seeded from the delivered tokens).
"""

import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.resilience import faults as jfaults
from paddle_tpu.inference import disagg as jdisagg
from paddle_tpu.inference import recovery as jrecovery
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.distributed.resilience import faults as tfaults
from paddle_tpu_torch.inference import disagg as tdisagg
from paddle_tpu_torch.inference import recovery as trecovery
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

torch.set_num_threads(1)

# the JAX disagg tests' engine (tests/test_serving_disagg.py)
ENGINE = dict(max_batch=2, max_len=32, page_size=8, block_size=2)


class _Pkg:
    """One package's serving surface, driven alike by the cases."""

    def __init__(self, name, serving, recovery, disagg, faults, model,
                 **engine_kw):
        self.name = name
        self.s, self.r, self.d, self.f = serving, recovery, disagg, faults
        self.model = model
        self.engine_kw = engine_kw

    def engine(self, **kw):
        kw = {**ENGINE, "prefix_cache": True, **self.engine_kw, **kw}
        return self.s.ContinuousBatchingEngine(self.model, **kw)

    def factory(self, **kw):
        return lambda: self.engine(**kw)


@pytest.fixture(scope="module")
def pkgs():
    paddle.seed(11)
    jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=1))
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                          device="cpu")
    load_jax_state(tm, state_from_jax_layer(jm))
    return (_Pkg("jax", jserving, jrecovery, jdisagg, jfaults, jm),
            _Pkg("torch", tserving, trecovery, tdisagg, tfaults, tm,
                 device="cpu"))


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n,)).astype(
        np.int32)


def _serve(eng, R, prompts, kws):
    reqs = [R(p, **kw) for p, kw in zip(prompts, kws)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done(max_steps=2000)
    assert all(r.done and not r.failed for r in reqs)
    return [list(r.tokens) for r in reqs]


def _to_ready(eng, req):
    eng.add_request(req)
    for _ in range(50):
        if req.rid in eng.migration_ready():
            return
        eng.step()
    raise AssertionError("the prefill never finished")


def _export(pkg, prompt, **kw):
    """(artifact, source engine, its request) of ``prompt``'s chain right
    after its first token."""
    src = pkg.engine()
    req = pkg.s.Request(prompt, **kw)
    _to_ready(src, req)
    return pkg.d.KVChainCodec().export_chain(src, req.rid), src, req


def _pool_state(eng):
    return (eng._alloc.free_blocks, len(eng._free_slots), len(eng._radix),
            len(eng._occupied))


def _continue(pkg, art, **engine_kw):
    dst = pkg.engine(**engine_kw)
    req = pkg.d.KVChainCodec().import_chain(dst, art)
    dst.run_until_done(max_steps=500)
    assert req.done and not req.failed
    return list(req.tokens), dst


# ---------------------------------------------------------------------------
# chain functions and the corrupt hook
# ---------------------------------------------------------------------------

def _pools(quant, layers=2, pages=7, kvh=2, page=4, d=8, seed=0):
    """The same pool bytes as JAX and port per-layer (k, v) lists."""
    rng = np.random.default_rng(seed)
    jkv, tkv = [], []
    for _ in range(layers):
        jpair, tpair = [], []
        for _ in range(2):
            if quant:
                data = rng.integers(-127, 128, (pages, kvh, page, d)).astype(
                    np.int8)
                scale = rng.random((pages, kvh)).astype(np.float32)
                jpair.append(jpa.QuantizedKVPool(jnp.asarray(data),
                                                 jnp.asarray(scale)))
                tpair.append(tpa.QuantizedKVPool(torch.from_numpy(data.copy()),
                                                 torch.from_numpy(
                                                     scale.copy())))
            else:
                data = rng.standard_normal((pages, kvh, page, d)).astype(
                    np.float32)
                jpair.append(jnp.asarray(data))
                tpair.append(torch.from_numpy(data.copy()))
        jkv.append(tuple(jpair))
        tkv.append(tuple(tpair))
    return jkv, tkv


def _pool_bytes(kv):
    out = []
    for pair in kv:
        for pool in pair:
            if isinstance(pool, tpa.QuantizedKVPool):
                out += [pool.data.numpy().tobytes(),
                        pool.scale.numpy().tobytes()]
            elif isinstance(pool, jpa.QuantizedKVPool):
                out += [np.asarray(pool.data).tobytes(),
                        np.asarray(pool.scale).tobytes()]
            elif isinstance(pool, torch.Tensor):
                out.append(pool.numpy().tobytes())
            else:
                out.append(np.asarray(pool).tobytes())
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_chain_gather_scatter_match_jax(quant):
    jkv, tkv = _pools(quant)
    blocks = [5, 1, 3]
    jpages = jpa.gather_chain_pages(jkv, blocks)
    tpages = tpa.gather_chain_pages(tkv, blocks)
    for (jk, jv), (tk, tv) in zip(jpages, tpages):
        assert tk.shape == tuple(jk.shape) == (3, 2, 4, 8)
        assert tk.numpy().tobytes() == jk.tobytes()
        assert tv.numpy().tobytes() == jv.tobytes()
    jsc = jpa.gather_chain_scales(jkv, blocks)
    tsc = tpa.gather_chain_scales(tkv, blocks)
    if not quant:
        assert jsc is None and tsc is None
    else:
        for (jk, jv), (tk, tv) in zip(jsc, tsc):
            assert tk.numpy().tobytes() == jk.tobytes()
            assert tv.numpy().tobytes() == jv.tobytes()
    # the chain written into other pages: JAX's new arrays, the port's
    # same tensors written in place
    dst = [6, 0, 2]
    jout = jpa.scatter_chain_pages(jkv, dst, jpages, scales=jsc)
    held = [t for pair in tkv for pool in pair
            for t in ((pool.data, pool.scale) if quant else (pool,))]
    ptrs = [t.data_ptr() for t in held]
    tout = tpa.scatter_chain_pages(tkv, dst, tpages, scales=tsc)
    assert tout is tkv
    assert [t.data_ptr() for t in held] == ptrs
    assert _pool_bytes(tout) == _pool_bytes(jout)
    # round trip: the written pages read back as the exported bytes
    again = tpa.gather_chain_pages(tkv, dst)
    assert [t.numpy().tobytes() for p in again for t in p] == \
        [t.numpy().tobytes() for p in tpages for t in p]


def test_int8_scatter_without_scales_raises_before_any_write():
    jkv, tkv = _pools(True)
    pages = tpa.gather_chain_pages(tkv, [1, 2])
    before = _pool_bytes(tkv)
    with pytest.raises(ValueError, match="scales"):
        jpa.scatter_chain_pages(jkv, [3, 4], jpa.gather_chain_pages(
            jkv, [1, 2]))
    with pytest.raises(ValueError, match="scales"):
        tpa.scatter_chain_pages(tkv, [3, 4], pages)
    assert _pool_bytes(tkv) == before


@pytest.mark.parametrize("action,arg", [("bitflip", 0), ("bitflip", 40),
                                        ("truncate", 0), ("truncate", 7),
                                        ("garbage", 0)])
@pytest.mark.parametrize("composed", [False, True])
def test_corrupt_hook_damages_the_same_bytes_as_jax(action, arg, composed):
    data = bytes(np.random.default_rng(3).integers(0, 256, 999).astype(
        np.uint8))
    out = []
    for f in (jfaults, tfaults):
        cls = f.ComposedFaultPlan if composed else f.FaultPlan
        plan = cls(seed=7, specs=[
            f.FaultSpec("serving.kv_transfer", action, at=1, arg=arg),
            f.FaultSpec("serving.kv_transfer", "bitflip", at=2, arg=3,
                        match="rid:9")])
        with plan:
            got = [f.corrupt("serving.kv_transfer", f"rid:{r}", data)
                   for r in (8, 9, 9, 10)]
        out.append((got, plan.log))
    assert out[0] == out[1]
    assert out[1][0][0] == data and out[1][0][1] != data
    assert tfaults.corrupt("serving.kv_transfer", "rid:1", data) is data


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chains(pkgs):
    """Port chains (greedy and seeded) right after the first token, with
    the uninterrupted streams of the same requests."""
    pkg = pkgs[1]
    prompt = _prompt(12, 5)
    out = {}
    for name, kw in (("greedy", dict(max_new_tokens=8)),
                     ("seeded", dict(max_new_tokens=8, temperature=0.9,
                                     seed=50))):
        ref = _serve(pkg.engine(), pkg.s.Request, [prompt], [kw])[0]
        art, src, req = _export(pkg, prompt, **kw)
        out[name] = dict(art=art, src=src, req=req, ref=ref, kw=kw,
                         prompt=prompt)
    src = pkg.engine(kv_cache="int8")
    req = pkg.s.Request(prompt, max_new_tokens=8)
    _to_ready(src, req)
    out["int8"] = dict(art=tdisagg.KVChainCodec().export_chain(src, req.rid))
    return out


@pytest.mark.parametrize("name", ["greedy", "seeded"])
def test_spliced_stream_continues_byte_for_byte(pkgs, chains, name):
    c = chains[name]
    codec = tdisagg.KVChainCodec()
    hdr = codec.peek(c["art"])
    assert hdr["pos"] == len(c["prompt"]) + len(hdr["delivered"])
    assert hdr["delivered"] == c["ref"][:len(hdr["delivered"])]
    assert hdr["dtype"] == "float32" and hdr["n_written"] == 2
    toks, dst = _continue(pkgs[1], c["art"])
    assert toks == c["ref"]
    # the migrated prompt's full page is cache-visible on the destination
    assert len(dst._radix) >= len(c["prompt"]) // dst.page_size


def test_source_unchanged_until_withdraw_active(pkgs, chains):
    pkg = pkgs[1]
    c = chains["greedy"]
    src = c["src"]
    assert c["req"].rid in src.migration_ready()
    src.run_until_done(max_steps=200)
    assert list(c["req"].tokens) == c["ref"]
    r2 = pkg.s.Request(c["prompt"], **c["kw"])
    _to_ready(src, r2)
    slot = src.slot_of(r2.rid)
    assert slot is not None and src.slot_of(10 ** 9) is None
    free = src._alloc.free_blocks + len(src._radix)
    assert src.withdraw_active(r2.rid)
    assert src.slot_of(r2.rid) is None and slot in src._free_slots
    assert not r2.done and not r2.failed
    assert src._alloc.free_blocks + len(src._radix) >= free
    assert not src.withdraw_active(r2.rid)
    assert not src.has_work()


def _forged(art, mutate):
    codec = tdisagg.KVChainCodec()
    hdr, payload = codec._parse(art)
    hdr = dict(hdr)
    mutate(hdr)
    hj = json.dumps(hdr, separators=(",", ":")).encode()
    return codec.MAGIC + (b"%08x" % len(hj)) + hj + bytes(payload)


@pytest.mark.parametrize("damage,match", [
    ("page_byte", "page 1 failed its crc32"),
    ("pos", "digest"), ("delivered", "digest"), ("seed", "digest"),
    ("truncate", "payload"), ("magic", "magic"), ("scales", "scales")])
def test_corruption_refused_with_destination_untouched(pkgs, chains, damage,
                                                       match):
    art = chains["int8" if damage == "scales" else "greedy"]["art"]
    if damage == "page_byte":
        bad = bytearray(art)
        bad[-10] ^= 0xFF
        art = bytes(bad)
    elif damage == "pos":
        art = _forged(art, lambda h: h.update(pos=h["pos"] + 8))
    elif damage == "delivered":
        art = _forged(art, lambda h: h.update(
            delivered=[h["delivered"][0] + 1] + h["delivered"][1:]))
    elif damage == "seed":
        art = _forged(art, lambda h: h.update(seed=h["seed"] + 1))
    elif damage == "truncate":
        art = art[:-7]
    elif damage == "magic":
        art = b"PTKV2" + art[5:]
    else:
        # an int8 chain without its scale table: refused before anything
        # moves (verify off, as the drill's control arm, so the digest
        # does not refuse it first)
        art = _forged(art, lambda h: h.pop("kv_scales"))
    dst = pkgs[1].engine(kv_cache="int8") if damage == "scales" \
        else pkgs[1].engine()
    before = _pool_state(dst)
    codec = tdisagg.KVChainCodec(verify_crc=damage != "scales")
    with pytest.raises(tdisagg.KVChainCorrupt, match=match):
        codec.import_chain(dst, art)
    assert _pool_state(dst) == before
    with pytest.raises(jdisagg.KVChainCorrupt, match=match):
        jdisagg.KVChainCodec(verify_crc=damage != "scales").import_chain(
            pkgs[0].engine(kv_cache="int8") if damage == "scales" else None,
            art)


def test_shortfall_is_engine_saturated_with_pool_untouched(pkgs, chains):
    art = chains["greedy"]["art"]
    dst = pkgs[1].engine()
    held = dst._alloc.hold(dst._alloc.num_blocks)
    assert held == dst._alloc.num_blocks
    with pytest.raises(tserving.EngineSaturated, match="shortfall"):
        tdisagg.KVChainCodec().import_chain(dst, art)
    dst._alloc.release_held()
    assert _pool_state(dst) == (dst._alloc.num_blocks, 2, 0, 0)
    dst._free_slots.clear()
    with pytest.raises(tserving.EngineSaturated, match="slot"):
        tdisagg.KVChainCodec().import_chain(dst, art)
    assert dst._alloc.free_blocks == dst._alloc.num_blocks


@pytest.mark.parametrize("over", [dict(page_size=16, max_len=64),
                                  dict(kv_cache="int8"),
                                  dict(prefix_cache=False)])
def test_geometry_mismatch_is_a_config_error(pkgs, chains, over):
    dst = pkgs[1].engine(**over)
    with pytest.raises(ValueError, match="geometry|prefix-cache"):
        tdisagg.KVChainCodec().import_chain(dst, chains["greedy"]["art"])


def test_export_refusals(pkgs):
    pkg = pkgs[1]
    codec = tdisagg.KVChainCodec()
    with pytest.raises(ValueError, match="prefix-cache"):
        codec.export_chain(pkg.engine(prefix_cache=False), 1)
    with pytest.raises(KeyError):
        codec.export_chain(pkg.engine(), 10 ** 9)


@pytest.mark.parametrize("kv_cache", [None, "int8"])
def test_int8_chain_travels_raw_with_scales(pkgs, kv_cache):
    """int8 pools: the payload is the raw int8 bytes and the scales ride
    the header; the spliced stream continues the uninterrupted one."""
    pkg = pkgs[1]
    prompt = _prompt(13, 9)
    kw = dict(max_new_tokens=8)
    ref = _serve(pkg.engine(kv_cache=kv_cache), pkg.s.Request, [prompt],
                 [kw])[0]
    src = pkg.engine(kv_cache=kv_cache)
    req = pkg.s.Request(prompt, **kw)
    _to_ready(src, req)
    art = tdisagg.KVChainCodec().export_chain(src, req.rid)
    hdr = tdisagg.KVChainCodec().peek(art)
    assert ("kv_scales" in hdr) == (kv_cache == "int8")
    assert hdr["dtype"] == ("int8" if kv_cache else "float32")
    toks, _ = _continue(pkg, art, kv_cache=kv_cache)
    assert toks == ref


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cross(pkgs):
    """A greedy chain exported by each package from the same prompt, and
    JAX's single-engine stream."""
    jp, tp = pkgs
    prompt = _prompt(11, 21)
    kw = dict(max_new_tokens=10)
    ref = _serve(jp.engine(), jp.s.Request, [prompt], [kw])[0]
    base = max(jserving.Request._counter[0], tserving.Request._counter[0])
    out = {"ref": ref}
    for pkg in pkgs:
        pkg.s.Request._counter[0] = base
        out[pkg.name] = _export(pkg, prompt, **kw)[0]
    return out


def test_one_wire_format_across_packages(cross):
    """The same chain exported by either package: equal headers (the
    page bytes differ in the last bits: two matmul libraries)."""
    jh = jdisagg.KVChainCodec().peek(cross["jax"])
    th = tdisagg.KVChainCodec().peek(cross["torch"])
    skip = ("page_crc", "digest")
    assert list(jh) == list(th)
    assert {k: v for k, v in jh.items() if k not in skip} == \
        {k: v for k, v in th.items() if k not in skip}


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_artifact_continues_in_the_other_package(pkgs, cross, src, dst):
    pkg = pkgs[1] if dst == "torch" else pkgs[0]
    toks, _ = _continue(pkg, cross[src])
    assert toks == cross["ref"]


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax"),
                                     ("torch", "torch")])
def test_import_then_reexport_gives_the_same_bytes(pkgs, cross, src, dst):
    pkg = pkgs[1] if dst == "torch" else pkgs[0]
    codec = pkg.d.KVChainCodec()
    eng = pkg.engine()
    req = codec.import_chain(eng, cross[src])
    assert codec.export_chain(eng, req.rid) == cross[src]


def test_int8_reexport_gives_the_same_bytes(pkgs, chains):
    """An int8 chain (raw bytes + header scales) re-exports to the same
    bytes after an import into either package."""
    art8 = chains["int8"]["art"]
    for pkg in pkgs:
        eng = pkg.engine(kv_cache="int8")
        codec = pkg.d.KVChainCodec()
        r = codec.import_chain(eng, art8)
        assert codec.export_chain(eng, r.rid) == art8


# ---------------------------------------------------------------------------
# the tiered router
# ---------------------------------------------------------------------------

def _wave(n=4, shared_page=True, sampled=True):
    """tests/test_serving_disagg.py's mixed wave: greedy and seeded; with
    ``shared_page`` the first prompt (one full page) repeats last, which
    takes the full-prompt-hit COW path on a warm radix."""
    rng = np.random.default_rng(77)
    pa = rng.integers(0, 256, (8,)).astype(np.int32)
    prompts, kws = [pa], [dict(max_new_tokens=6, seed=300)]
    for i in range(1, n - 1):
        prompts.append(rng.integers(0, 256, (6 + i,)).astype(np.int32))
        kw = dict(max_new_tokens=8, seed=300 + i)
        if i % 2 == 1 and sampled:
            kw.update(temperature=0.9)
        kws.append(kw)
    prompts.append(pa)
    kws.append(dict(max_new_tokens=8, seed=300 if shared_page else 399))
    return prompts, kws


def _tiered(pkg, d, build_decode=None, **kw):
    return pkg.d.TieredRouter(pkg.factory(), build_decode or pkg.factory(),
                              str(d), num_prefill=1, num_decode=1, **kw)


def _run(router, R, prompts, kws):
    reqs = [R(p, **kw) for p, kw in zip(prompts, kws)]
    for r in reqs:
        router.submit(r)
    router.run_until_done(max_steps=3000)
    assert not [r.rid for r in reqs if r.failed or not r.done]
    return [list(r.tokens) for r in reqs], reqs


def test_prefixless_tier_refused_at_construction(pkgs, tmp_path):
    pkg = pkgs[1]
    with pytest.raises(ValueError, match="prefix cache"):
        pkg.d.TieredRouter(pkg.factory(prefix_cache=False), pkg.factory(),
                           str(tmp_path), num_prefill=1, num_decode=1)
    with pytest.raises(ValueError, match="each tier"):
        pkg.d.TieredRouter(pkg.factory(), pkg.factory(), str(tmp_path),
                           num_prefill=0, num_decode=1)
    # tracing is ported: one recorder reaches both tiers' engines, each
    # stamping with its replica tag
    from paddle_tpu_torch.observability import TraceRecorder
    tr = TraceRecorder()
    tiered = _tiered(pkg, tmp_path / "t", tracer=tr)
    try:
        assert tiered.tracer is tr
        assert [(rep.sup.engine.tracer is tr,
                 rep.sup.engine.trace_tags) for rep in tiered.replicas] == [
            (True, {"replica": 0}), (True, {"replica": 1})]
    finally:
        tiered.close()


def test_incompatible_decode_tier_decodes_in_place(pkgs, tmp_path):
    pkg = pkgs[1]
    tiered = _tiered(pkg, tmp_path,
                     build_decode=pkg.factory(page_size=16, max_len=64))
    try:
        streams, _ = _run(tiered, pkg.s.Request, [_prompt(8, 9)],
                          [dict(max_new_tokens=4, seed=12)])
    finally:
        tiered.close()
    assert len(streams[0]) == 4
    st = tiered.stats
    assert st["migrations"] == st["migration_reprefill"] == 0
    assert st["migration_deferred"] >= 1
    recs = trecovery.RequestJournal.load(tiered.replicas[0].journal_path)
    assert not any(r["k"] == "migr-kv" for r in recs)


def test_tiered_equals_single_warm_cold_cow(pkgs, tmp_path):
    """Greedy and seeded streams through a 1+1 tier, cold then warm (the
    repeat of the first prompt takes the COW path on the warm prefill
    radix), byte-identical to one engine; every migration journaled."""
    pkg = pkgs[1]
    prompts, kws = _wave()
    eng = pkg.engine()
    refs = [_serve(eng, pkg.s.Request, prompts, kws) for _ in range(2)]
    tiered = _tiered(pkg, tmp_path)
    try:
        for wave in range(2):
            streams, _ = _run(tiered, pkg.s.Request, prompts, kws)
            assert streams == refs[wave], wave
        st = tiered.stats
        assert st["migrations"] >= 2 and st["migration_pages"] >= 2
        assert st["migration_bytes"] > 0 and st["migration_corrupt"] == 0
        assert len(tiered.migration_samples) == st["migrations"]
        assert tiered.replicas[0].sup.engine.stats["cow_copies"] > 0
        recs = trecovery.RequestJournal.load(tiered.replicas[0].journal_path)
        assert sum(r["k"] == "migr-kv" for r in recs) == \
            st["migrations"] + st["migration_reprefill"]
        assert not trecovery.RequestJournal.pending(recs)
        assert [rep.tier for rep in tiered.replicas] == ["prefill", "decode"]
    finally:
        tiered.close()


@pytest.fixture(scope="module")
def jax_tiered(pkgs, tmp_path_factory):
    """The greedy wave through JAX's single engine and JAX's 1+1 tier, from
    the rids the port's runs will reuse."""
    jp = pkgs[0]
    prompts, kws = _wave(sampled=False)
    base = max(jserving.Request._counter[0],
               tserving.Request._counter[0]) + 1
    ref = _serve(jp.engine(), jp.s.Request, prompts, kws)
    d = tmp_path_factory.mktemp("jax_tiered")
    jserving.Request._counter[0] = base
    tiered = _tiered(jp, d)
    try:
        streams, _ = _run(tiered, jp.s.Request, prompts, kws)
    finally:
        tiered.close()
    return dict(ref=ref, streams=streams, dir=d, base=base,
                stats=dict(tiered.stats), prompts=prompts, kws=kws)


def _journal_view(r, d, drop=("seconds",)):
    """{file: (records minus ``drop``, pending rids)} of a fleet dir,
    loaded by package ``r``'s RequestJournal."""
    out = {}
    for name in sorted(os.listdir(d)):
        recs = r.RequestJournal.load(os.path.join(d, name))
        out[name] = ([{k: v for k, v in x.items() if k not in drop}
                      for x in recs],
                     [x["rid"] for x in r.RequestJournal.pending(recs)])
    return out


def test_tiered_greedy_equals_jax_and_journals_cross(pkgs, jax_tiered,
                                                     tmp_path):
    """The port's tiered greedy streams equal JAX's single engine (and
    JAX's tier); with the same rids the two routers write the same
    journal records, and each package's loader reads the other's with the
    same pending() set (``migr-kv`` terminal)."""
    tp = pkgs[1]
    j = jax_tiered
    assert j["streams"] == j["ref"]
    tserving.Request._counter[0] = j["base"]
    tiered = _tiered(tp, tmp_path)
    try:
        streams, _ = _run(tiered, tp.s.Request, j["prompts"], j["kws"])
    finally:
        tiered.close()
    assert streams == j["ref"]
    keys = ("migrations", "migration_pages", "migration_reprefill",
            "migration_deferred", "migration_refused", "migration_corrupt")
    assert {k: tiered.stats[k] for k in keys} == \
        {k: j["stats"][k] for k in keys}
    assert _journal_view(trecovery, tmp_path) == \
        _journal_view(jrecovery, tmp_path)
    assert _journal_view(trecovery, j["dir"]) == \
        _journal_view(jrecovery, j["dir"])
    # across packages the records differ only in the chain digests (the
    # page bytes of two matmul libraries differ in their last bits)
    mine = _journal_view(trecovery, tmp_path, drop=("seconds", "digest"))
    assert _journal_view(jrecovery, j["dir"],
                         drop=("seconds", "digest")) == mine
    kinds = [x["k"] for x in mine["replica0.g0.jrnl"][0]]
    assert "migr-kv" in kinds and not mine["replica0.g0.jrnl"][1]
    assert [x["k"] for x in mine["replica1.g0.jrnl"][0]].count("fin") == \
        tiered.stats["migrations"]


def test_mid_migration_decode_kill_replays_exactly(pkgs, tmp_path):
    """The decode replica dies after chains were spliced into it: failover
    re-runs their prefill on the prefill replica from the decode journal,
    verifies the delivered prefixes and streams on; every stream equals
    one engine's and every rid finishes exactly once across the
    journals."""
    pkg = pkgs[1]
    prompts, kws = _wave(shared_page=False)
    ref = _serve(pkg.engine(), pkg.s.Request, prompts, kws)
    plan = tfaults.FaultPlan(seed=5, specs=[tfaults.FaultSpec(
        "fleet.replica_kill", "kill", at=2, count=1, match="replica:1:")])
    tiered = _tiered(pkg, tmp_path)
    try:
        with plan:
            streams, reqs = _run(tiered, pkg.s.Request, prompts, kws)
    finally:
        tiered.close()
    assert plan.log, "the replica kill never fired"
    st = tiered.stats
    assert st["replica_deaths"] == 1 and st["failovers"] == 1
    assert st["failover_requests"] >= 1 and st["migrations"] >= 1
    assert streams == ref
    fins = {}
    for name in os.listdir(tmp_path):
        for x in trecovery.RequestJournal.load(os.path.join(tmp_path, name)):
            if x["k"] == "fin" and not x["failed"]:
                fins[x["rid"]] = fins.get(x["rid"], 0) + 1
    assert fins == {r.rid: 1 for r in reqs}


def test_corrupt_transfer_reprefills_on_the_decode_tier(pkgs, tmp_path):
    """A flipped bit in transit: PT-SRV-007, the chain is not spliced, the
    decode replica re-runs the prefill and verifies the delivered prefix;
    the streams stay byte-identical."""
    pkg = pkgs[1]
    prompts, kws = _wave(shared_page=False)
    ref = _serve(pkg.engine(), pkg.s.Request, prompts, kws)
    plan = tfaults.FaultPlan(seed=7, specs=[tfaults.FaultSpec(
        "serving.kv_transfer", "bitflip", at=1)])
    tiered = _tiered(pkg, tmp_path)
    try:
        with plan:
            streams, _ = _run(tiered, pkg.s.Request, prompts, kws)
    finally:
        tiered.close()
    assert plan.fired() == {"serving.kv_transfer": 1}
    st = tiered.stats
    assert st["migration_corrupt"] == 1 and st["migration_reprefill"] == 1
    assert "PT-SRV-007" in [c for c, _ in tiered.events]
    assert streams == ref


# ---------------------------------------------------------------------------
# spec decode tiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("history,plen,extra", [(16, 5, 3), (16, 14, 6),
                                                (8, 3, 0), (8, 20, 11)])
def test_spec_seed_with_delivered_tokens_matches_jax(history, plen, extra):
    prompt = np.arange(100, 100 + plen, dtype=np.int32)
    delivered = list(range(500, 500 + extra))
    want = jserving.ContinuousBatchingEngine._spec_seed(
        types.SimpleNamespace(_spec=jserving.SpecConfig(history=history)),
        prompt, extra=delivered)
    got = tserving.ContinuousBatchingEngine._spec_seed(
        types.SimpleNamespace(_spec=tserving.SpecConfig(history=history)),
        prompt, extra=delivered)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == plen + extra


def test_migrated_spec_stream_and_acceptance_equal_jax(pkgs):
    """A motif prompt's chain, exported after a speculative dispatch past
    its first token, spliced into a spec engine: the stream and the
    destination's drafter counts equal JAX's (the ring re-seeded from
    prompt + delivered tokens)."""
    motif = _prompt(5, 41)
    prompt = np.tile(motif, 3)
    spec_kw = dict(max_batch=2, max_len=64, page_size=8, block_size=2,
                   fused=True, speculative=None)
    out = []
    base = max(jserving.Request._counter[0], tserving.Request._counter[0])
    for pkg in pkgs:
        pkg.s.Request._counter[0] = base
        spec_kw["speculative"] = pkg.s.SpecConfig(k=4)
        src = pkg.engine(**spec_kw)
        req = pkg.s.Request(prompt, max_new_tokens=24)
        _to_ready(src, req)
        src.step()
        codec = pkg.d.KVChainCodec()
        art = codec.export_chain(src, req.rid)
        dst = pkg.engine(**spec_kw)
        r = codec.import_chain(dst, art)
        dst.run_until_done(max_steps=500)
        st = dst.stats
        out.append((codec.peek(art)["delivered"], list(r.tokens),
                    st["spec_steps"], st["spec_proposed"],
                    st["spec_accepted"]))
    assert out[0] == out[1]
    assert len(out[1][0]) > 1 and out[1][4] > 0

"""The port's ``incubate.nn.functional`` fused family against the JAX
package's, on the same numpy inputs (seeded), on the CPU: the norms,
``swiglu``, the rotary embedding, the bias/linear fusions, the dropout
fusions, ``fused_multi_head_attention`` (with a growing cache),
``fused_feedforward``, ``masked_multihead_attention`` (dense cache written
in place, rope, masks), ``variable_length_memory_efficient_attention`` and
``fused_multi_transformer`` (prefill into per-layer caches, then cached
decode steps).

Tolerance: fp32 results within atol 2e-5 + rtol 2e-5 (the same fp32
arithmetic in another summation order); the caches a function writes are
byte-equal where they are copies of inputs, within 1e-6 where rope
computed them. On the CPU the attention of both packages is the plain
dense path (the JAX flash kernel's off-TPU route, the port's plain
version of K1). Dropout's bits differ between the packages, so training
mode is held to its statistics.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.incubate.nn.functional as JF
import paddle_tpu_torch.incubate.nn.functional as TF

TOL = dict(atol=2e-5, rtol=2e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def J(a):
    return jp.to_tensor(a)


def T(a):
    return torch.from_numpy(np.array(a))


def N(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x._data if hasattr(x, "_data") else x)


def close(got, ref, **tol):
    np.testing.assert_allclose(N(got), N(ref), **(tol or TOL))


# ---- norms, swiglu, rotary -------------------------------------------------

@pytest.mark.parametrize("residual,bias", [(False, False), (True, True)])
def test_fused_rms_norm(residual, bias):
    r = _rng(1)
    x, w = _f32(r, 2, 5, 16), _f32(r, 16)
    res, b = _f32(r, 2, 5, 16), _f32(r, 16)
    kw = lambda f: dict(norm_bias=f(b) if bias else None,
                        residual=f(res) if residual else None)
    close(TF.fused_rms_norm(T(x), T(w), **kw(T)),
          JF.fused_rms_norm(J(x), J(w), **kw(J)))


def test_fused_rms_norm_refuses_what_jax_ignores():
    with pytest.raises(NotImplementedError, match="bias"):
        TF.fused_rms_norm(torch.ones(2, 4), torch.ones(4),
                          bias=torch.ones(4))


@pytest.mark.parametrize("residual", [False, True])
def test_fused_layer_norm(residual):
    r = _rng(2)
    x, w, b, res = _f32(r, 3, 16), _f32(r, 16), _f32(r, 16), _f32(r, 3, 16)
    close(TF.fused_layer_norm(T(x), T(w), T(b),
                              residual=T(res) if residual else None),
          JF.fused_layer_norm(J(x), J(w), J(b),
                              residual=J(res) if residual else None))


@pytest.mark.parametrize("two", [False, True])
def test_swiglu(two):
    r = _rng(3)
    x, y = _f32(r, 4, 8), _f32(r, 4, 8)
    if two:
        close(TF.swiglu(T(x), T(y)), JF.swiglu(J(x), J(y)))
    else:
        close(TF.swiglu(T(x)), JF.swiglu(J(x)))


@pytest.mark.parametrize("neox,given,pos", [
    (True, False, False), (False, False, False), (True, True, False),
    (True, False, True), (False, True, True)])
def test_fused_rotary_position_embedding(neox, given, pos):
    r = _rng(4)
    b, s, h, d = 2, 6, 3, 8
    q, k = _f32(r, b, s, h, d), _f32(r, b, s, h, d)
    ang = r.uniform(0, 6, (s, d)).astype(np.float32)
    pid = r.integers(0, s, (b, s)).astype(np.int64)

    def call(mod, f):
        kw = dict(use_neox_rotary_style=neox)
        if given:
            kw.update(sin=f(np.sin(ang)), cos=f(np.cos(ang)))
        if pos:
            kw["position_ids"] = f(pid)
        return mod.fused_rotary_position_embedding(f(q), f(k), **kw)

    got, ref = call(TF, T), call(JF, J)
    assert got[2] is None and ref[2] is None
    close(got[0], ref[0])
    close(got[1], ref[1])


# ---- bias / activation / linear fusions ------------------------------------

@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
def test_fused_bias_act(act):
    r = _rng(5)
    x, b = _f32(r, 4, 8), _f32(r, 8)
    close(TF.fused_bias_act(T(x), T(b), act_method=act),
          JF.fused_bias_act(J(x), J(b), act_method=act))


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear(transpose):
    r = _rng(6)
    x = _f32(r, 3, 4, 8)
    w = _f32(r, 16, 8) if transpose else _f32(r, 8, 16)
    b = _f32(r, 16)
    close(TF.fused_linear(T(x), T(w), T(b), transpose_weight=transpose),
          JF.fused_linear(J(x), J(w), J(b), transpose_weight=transpose))


@pytest.mark.parametrize("act,trans_y", [("gelu", False), ("relu", True),
                                         ("none", False), ("tanh", True)])
def test_fused_linear_activation(act, trans_y):
    r = _rng(7)
    x = _f32(r, 5, 8)
    y = _f32(r, 6, 8) if trans_y else _f32(r, 8, 6)
    b = _f32(r, 6)
    close(TF.fused_linear_activation(T(x), T(y), T(b), trans_y=trans_y,
                                     activation=act),
          JF.fused_linear_activation(J(x), J(y), J(b), trans_y=trans_y,
                                     activation=act))


@pytest.mark.parametrize("tx,ty,bias", [(False, False, True),
                                        (True, True, False),
                                        (False, True, True)])
def test_fused_matmul_bias(tx, ty, bias):
    r = _rng(8)
    x = _f32(r, 2, 8, 5) if tx else _f32(r, 2, 5, 8)
    y = _f32(r, 6, 8) if ty else _f32(r, 8, 6)
    b = _f32(r, 6)
    close(TF.fused_matmul_bias(T(x), T(y), T(b) if bias else None, tx, ty),
          JF.fused_matmul_bias(J(x), J(y), J(b) if bias else None, tx, ty))


def test_fused_dropout_add_eval_and_train():
    r = _rng(9)
    x, y = _f32(r, 64, 64), _f32(r, 64, 64)
    close(TF.fused_dropout_add(T(x), T(y), p=0.3, training=False),
          JF.fused_dropout_add(J(x), J(y), p=0.3, training=False))
    out = N(TF.fused_dropout_add(T(x), T(y), p=0.3)) - y
    dropped = np.isclose(out, 0.0)
    # 4096 Bernoulli(0.3) draws: mean 0.3, sd 0.0072; 6 sd
    assert abs(dropped.mean() - 0.3) < 0.044
    np.testing.assert_allclose(out[~dropped], x[~dropped] / 0.7, **TOL)


def test_fused_bias_dropout_residual_layer_norm():
    r = _rng(10)
    x, res, b = _f32(r, 3, 4, 16), _f32(r, 3, 4, 16), _f32(r, 16)
    s, lb = _f32(r, 16), _f32(r, 16)
    close(TF.fused_bias_dropout_residual_layer_norm(
        T(x), T(res), T(b), T(s), T(lb), dropout_rate=0.5, training=False),
        JF.fused_bias_dropout_residual_layer_norm(
            J(x), J(res), J(b), J(s), J(lb), dropout_rate=0.5,
            training=False))


# ---- attention blocks -------------------------------------------------------

@pytest.mark.parametrize("pre_ln,cache,mask,transposed", [
    (False, False, False, False), (True, True, True, False),
    (True, False, True, True)])
def test_fused_multi_head_attention(pre_ln, cache, mask, transposed):
    r = _rng(11)
    b, s, nh, hd, clen = 2, 5, 2, 8, 3
    dim = nh * hd
    x = _f32(r, b, s, dim)
    qkvw = _f32(r, dim, 3 * dim, scale=0.2) if transposed else \
        _f32(r, 3, nh, hd, dim, scale=0.2)
    lw = _f32(r, dim, dim, scale=0.2)
    qb = _f32(r, 3 * dim) if transposed else _f32(r, 3, nh, hd)
    vecs = [_f32(r, dim) for _ in range(5)]
    ckv = _f32(r, 2, b, nh, clen, hd)
    kv_len = s + (clen if cache else 0)
    m = np.where(r.random((b, 1, s, kv_len)) < 0.8, 0.0, -1e4).astype(
        np.float32)

    def call(mod, f):
        c = f(ckv) if cache else None
        out = mod.fused_multi_head_attention(
            f(x), f(qkvw), f(lw), pre_layer_norm=pre_ln,
            pre_ln_scale=f(vecs[0]), pre_ln_bias=f(vecs[1]),
            ln_scale=f(vecs[2]), ln_bias=f(vecs[3]), qkv_bias=f(qb),
            linear_bias=f(vecs[4]), cache_kv=c,
            attn_mask=f(m) if mask else None, training=False,
            num_heads=nh, transpose_qkv_wb=transposed)
        return out, c

    (got, gc), (ref, rc) = call(TF, T), call(JF, J)
    if cache:
        close(got[0], ref[0])
        assert tuple(gc.shape) == (2, b, nh, clen + s, hd)
        close(gc, rc)
        close(got[1], ref[1])
    else:
        close(got, ref)


@pytest.mark.parametrize("pre_ln,act", [(False, "relu"), (True, "gelu")])
def test_fused_feedforward(pre_ln, act):
    r = _rng(12)
    x = _f32(r, 2, 5, 16)
    w1, w2 = _f32(r, 16, 32, scale=0.3), _f32(r, 32, 16, scale=0.3)
    vecs = [_f32(r, n) for n in (32, 16, 16, 16, 16, 16)]

    def call(mod, f):
        return mod.fused_feedforward(
            f(x), f(w1), f(w2), f(vecs[0]), f(vecs[1]), f(vecs[2]),
            f(vecs[3]), f(vecs[4]), f(vecs[5]), activation=act,
            pre_layer_norm=pre_ln, training=False)

    close(call(TF, T), call(JF, J))


@pytest.mark.parametrize("rope,neox,mask,half", [
    (False, False, False, False), (False, False, True, False),
    (True, True, False, False), (True, False, True, True)])
def test_masked_multihead_attention(rope, neox, mask, half):
    r = _rng(13)
    b, nh, hd, max_seq = 3, 2, 8, 12
    x = _f32(r, b, 3 * nh * hd)
    cache = _f32(r, 2, b, nh, max_seq, hd)
    lens = np.array([[3], [7], [0]], np.int32)
    bias = _f32(r, 3 * nh * hd)
    src_mask = _f32(r, b, 1, 1, 8)
    rot = r.uniform(0, 6, (1, max_seq, 1, hd // 2 if half else hd))
    rot = np.stack([np.cos(rot), np.sin(rot)]).astype(np.float32)

    def call(mod, f):
        c = f(cache)
        out = mod.masked_multihead_attention(
            f(x), c, bias=f(bias), src_mask=f(src_mask) if mask else None,
            sequence_lengths=f(lens), rotary_tensor=f(rot) if rope else None,
            rotary_emb_dims=1 if rope else 0,
            use_neox_rotary_style=neox)
        return out, c

    (got, gc), (ref, rc) = call(TF, T), call(JF, J)
    close(got[0], ref[0])
    if rope:
        np.testing.assert_allclose(N(gc), N(rc), atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(N(gc), N(rc))
    assert got[1] is gc


def test_masked_multihead_attention_refusals_as_in_jax():
    x, c = torch.zeros(1, 48), torch.zeros(2, 1, 2, 4, 8)
    lens = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="quantization"):
        TF.masked_multihead_attention(x, c, sequence_lengths=lens,
                                      out_scale=1.0)
    with pytest.raises(NotImplementedError, match="rotary_emb_dims=2"):
        TF.masked_multihead_attention(x, c, sequence_lengths=lens,
                                      rotary_emb_dims=2)


@pytest.mark.parametrize("causal,mask", [(False, False), (True, False),
                                         (False, True)])
def test_variable_length_memory_efficient_attention(causal, mask):
    r = _rng(14)
    q, k, v = (_f32(r, 2, 6, 2, 8) for _ in range(3))
    m = _f32(r, 2, 2, 6, 6)
    full = np.array([6, 6], np.int32)

    def call(mod, f):
        return mod.variable_length_memory_efficient_attention(
            f(q), f(k), f(v), f(full), f(full), f(m) if mask else None,
            causal=causal)

    close(call(TF, T), call(JF, J))
    with pytest.raises(NotImplementedError, match="seq_lens"):
        TF.variable_length_memory_efficient_attention(
            T(q), T(k), T(v), T(np.array([6, 3], np.int32)))


def _mt_weights(r, layers, d, ffn):
    def per(*shape, scale=0.1):
        return [_f32(r, *shape, scale=scale) for _ in range(layers)]

    return dict(ln_scales=per(d, scale=1.0), ln_biases=per(d),
                qkv_weights=per(3 * d, d), qkv_biases=per(3 * d),
                linear_weights=per(d, d), linear_biases=per(d),
                ffn_ln_scales=per(d, scale=1.0), ffn_ln_biases=per(d),
                ffn1_weights=per(d, ffn), ffn1_biases=per(ffn),
                ffn2_weights=per(ffn, d), ffn2_biases=per(d))


@pytest.mark.parametrize("pre_ln,act", [(True, "gelu"), (False, "relu")])
def test_fused_multi_transformer_prefill_and_decode(pre_ln, act):
    """Prefill 2 x 5 tokens into 2 layers' caches, then 3 decode steps
    (time_step as an int and as a tensor): outputs and caches agree."""
    r = _rng(15)
    layers, b, s, nh, hd, ffn, max_seq = 2, 2, 5, 2, 8, 32, 10
    d = nh * hd
    w = _mt_weights(r, layers, d, ffn)
    x = _f32(r, b, s, d)
    steps = [_f32(r, b, 1, d) for _ in range(3)]

    def run(mod, f):
        kw = {k: [f(a) for a in v] for k, v in w.items()}
        caches = [f(np.zeros((2, b, nh, max_seq, hd), np.float32))
                  for _ in range(layers)]
        outs = [mod.fused_multi_transformer(
            f(x), pre_layer_norm=pre_ln, cache_kvs=caches, activation=act,
            num_heads=nh, **kw)]
        for i, xs in enumerate(steps):
            ts = s + i if i % 2 == 0 else f(np.array([s + i], np.int32))
            outs.append(mod.fused_multi_transformer(
                f(xs), pre_layer_norm=pre_ln, cache_kvs=caches, time_step=ts,
                activation=act, num_heads=nh, **kw))
        return outs, caches

    (got, gcs), (ref, rcs) = run(TF, T), run(JF, J)
    for g, rr in zip(got, ref):
        close(g, rr, atol=5e-5, rtol=5e-5)
    for gc, rc in zip(gcs, rcs):
        close(gc, rc, atol=5e-5, rtol=5e-5)


def test_fused_multi_transformer_without_cache():
    r = _rng(16)
    w = _mt_weights(r, 2, 16, 32)
    x = _f32(r, 2, 7, 16)
    got = TF.fused_multi_transformer(
        T(x), num_heads=2, **{k: [T(a) for a in v] for k, v in w.items()})
    ref = JF.fused_multi_transformer(
        J(x), num_heads=2, **{k: [J(a) for a in v] for k, v in w.items()})
    close(got, ref, atol=5e-5, rtol=5e-5)
    with pytest.raises(ValueError, match="num_heads"):
        TF.fused_multi_transformer(T(x), **{k: [T(a) for a in v]
                                            for k, v in w.items()})

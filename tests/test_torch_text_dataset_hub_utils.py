"""The port's ``text``, ``dataset``, ``hub``, ``utils`` and ``version``
against the JAX package's, on the CPU.

- ``viterbi_decode`` / ``ViterbiDecoder``: scores within 1e-5 (fp32 sums of
  the same terms), paths equal, with and without the BOS/EOS tags, lengths
  from 1 to the full sequence.
- The synthetic text datasets and the legacy readers: every item
  byte-equal (both draw from ``numpy.random.default_rng((seed, idx))``).
- ``hub`` over a local ``hubconf.py``; remote sources refused as in JAX.
- ``utils``: ``try_import``, ``custom_op`` with and without a ``vjp``
  (values and gradients within 1e-6), a ``cpp_extension`` op compiled by
  g++ (forward equal, its ``_grad`` as the backward), ``run_check`` on the
  CPU; ``version``'s fields.
"""

import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device


@pytest.fixture(autouse=True)
def _cpu():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def N(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x._data if hasattr(x, "_data") else x)


# ---- text -------------------------------------------------------------------

@pytest.mark.parametrize("bos_eos", [True, False])
def test_viterbi_decode_matches_jax(bos_eos):
    rng = np.random.default_rng(int(bos_eos))
    b, t, n = 5, 7, 6
    emit = rng.standard_normal((b, t, n)).astype(np.float32)
    trans = rng.standard_normal((n, n)).astype(np.float32)
    lens = np.array([7, 1, 4, 7, 3], np.int64)
    js, jpth = jp.text.viterbi_decode(jp.to_tensor(emit), jp.to_tensor(trans),
                                      jp.to_tensor(lens), bos_eos)
    ts, tpth = pt.text.viterbi_decode(torch.from_numpy(emit),
                                      torch.from_numpy(trans),
                                      torch.from_numpy(lens), bos_eos)
    np.testing.assert_allclose(N(ts), N(js), atol=1e-5, rtol=1e-5)
    assert tpth.dtype == torch.int64
    np.testing.assert_array_equal(N(tpth), N(jpth))
    dec = pt.text.ViterbiDecoder(torch.from_numpy(trans), bos_eos)
    np.testing.assert_array_equal(
        N(dec(torch.from_numpy(emit), torch.from_numpy(lens))[1]), N(jpth))


@pytest.mark.parametrize("name", ["Imdb", "Imikolov", "UCIHousing",
                                  "Conll05st", "Movielens", "WMT14", "WMT16"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_text_datasets_byte_equal(name, mode):
    jd = getattr(jp.text, name)(mode=mode, size=20)
    td = getattr(pt.text, name)(mode=mode, size=20)
    assert len(td) == len(jd) == 20
    for i in (0, 7, 19):
        for a, b in zip(td[i], jd[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert np.asarray(a).dtype == np.asarray(b).dtype


# ---- the legacy readers ----------------------------------------------------

@pytest.mark.parametrize("reader", [
    "mnist.train", "mnist.test", "cifar.train10", "cifar.test10",
    "cifar.train100", "cifar.test100", "uci_housing.train",
    "uci_housing.test"])
def test_legacy_readers_byte_equal(reader):
    mod, fn = reader.split(".")
    import paddle_tpu.dataset as JDs
    import paddle_tpu_torch.dataset as TDs

    args = () if mod == "uci_housing" else (6,)
    got = list(getattr(getattr(TDs, mod), fn)(*args)())
    ref = list(getattr(getattr(JDs, mod), fn)(*args)())
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert pt.dataset.uci_housing.feature_names == \
        jp.dataset.uci_housing.feature_names


def test_cluster_files_reader(tmp_path):
    for i in range(5):
        (tmp_path / f"part-{i}").write_bytes(bytes([i]))
    pattern = str(tmp_path / "part-*")
    got = list(pt.dataset.common.cluster_files_reader(pattern, 2, 1)())
    ref = list(jp.dataset.common.cluster_files_reader(pattern, 2, 1)())
    assert got == ref == [b"\x01", b"\x03"]


# ---- hub --------------------------------------------------------------------

def test_hub_local(tmp_path):
    (tmp_path / "hubconf.py").write_text(textwrap.dedent('''
        dependencies = ["numpy"]

        def tiny(width=3):
            """A tiny model."""
            return ("tiny", width)

        def _hidden():
            pass
    '''))
    repo = str(tmp_path)
    assert pt.hub.list(repo, source="local") == \
        jp.hub.list(repo, source="local") == ["tiny"]
    assert pt.hub.help(repo, "tiny", source="local") == "A tiny model."
    assert pt.hub.load(repo, "tiny", source="local", width=5) == ("tiny", 5)
    with pytest.raises(RuntimeError, match="remote"):
        pt.hub.load(repo, "tiny", source="github")
    with pytest.raises(ValueError, match="source"):
        pt.hub.list(repo, source="ftp")


# ---- utils and version ------------------------------------------------------

def test_try_import_and_version():
    assert pt.utils.try_import("math") is not None
    assert pt.utils.try_import("no_such_module_here") is None
    v, jv = pt.version, jp.version
    assert (v.full_version, v.major, v.minor, v.patch, v.rc) == \
        (jv.full_version, jv.major, jv.minor, jv.patch, jv.rc)
    assert v.torch == torch.__version__
    assert v.cuda() == (torch.version.cuda or "False")


def test_custom_op_with_and_without_vjp():
    from paddle_tpu.utils import custom_op as jcustom
    from paddle_tpu_torch.utils import custom_op as tcustom

    @tcustom("t_cube")
    def t_cube(x):
        return x * x * x

    @jcustom("j_cube")
    def j_cube(x):
        return x * x * x

    @tcustom("t_scaled", vjp=lambda x, g: g * 10.0)
    def t_scaled(x):
        return x * 2.0

    x = np.linspace(-2, 2, 7).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    jx = jp.to_tensor(x)
    jx.stop_gradient = False
    ty, jy = t_cube(tx), j_cube(jx)
    np.testing.assert_allclose(N(ty), N(jy), rtol=1e-6)
    ty.sum().backward()
    jy.sum().backward()
    np.testing.assert_allclose(N(tx.grad), N(jx.grad), rtol=1e-6)
    from paddle_tpu_torch.core import op_registry

    assert "t_cube" in op_registry.OPS and t_cube._kernel is not None
    tx.grad = None
    t_scaled(tx).sum().backward()
    np.testing.assert_array_equal(N(tx.grad), np.full(7, 10.0, np.float32))


_CPP = textwrap.dedent("""
    #include <cstdint>
    extern "C" const char* pt_op_list() { return "relu6,scale2"; }
    extern "C" void relu6(const float* x, float* y, int64_t n) {
        for (int64_t i = 0; i < n; ++i) {
            float v = x[i] < 0 ? 0 : x[i];
            y[i] = v > 6 ? 6 : v;
        }
    }
    extern "C" void relu6_grad(const float* x, const float* gy, float* gx,
                               int64_t n) {
        for (int64_t i = 0; i < n; ++i)
            gx[i] = (x[i] > 0 && x[i] < 6) ? gy[i] : 0;
    }
    extern "C" void scale2(const float* x, float* y, int64_t n) {
        for (int64_t i = 0; i < n; ++i) y[i] = 2 * x[i];
    }
""")


def test_cpp_extension_forward_and_grad(tmp_path):
    from paddle_tpu.utils import cpp_extension as jcpp
    from paddle_tpu_torch.utils import cpp_extension as tcpp

    src = tmp_path / "ops.cc"
    src.write_text(_CPP)
    text, jext = tcpp.load("port_test_ops", [str(src)]), jcpp.load(
        "port_test_ops", [str(src)])
    assert text.op_names == jext.op_names == ["relu6", "scale2"]
    x = np.array([-1.0, 0.5, 3.0, 7.0, 6.5], np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = text.relu6(tx)
    np.testing.assert_array_equal(N(y), N(jext.relu6(jp.to_tensor(x))))
    (y * torch.arange(5.0)).sum().backward()
    np.testing.assert_array_equal(N(tx.grad), [0, 1, 2, 0, 0])
    np.testing.assert_array_equal(N(text.scale2(torch.from_numpy(x))), 2 * x)
    assert tcpp.load("port_test_ops", [str(src)]).so_path == text.so_path


def test_run_check_on_cpu(capsys):
    pt.utils.run_check()
    out = capsys.readouterr().out
    assert "works well on 1 CPU" in out

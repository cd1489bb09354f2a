"""``paddle_tpu_torch.fft``, ``signal`` and ``audio`` against the JAX
package's on the CPU, fp32, numpy inputs from a seed
(tests/torch_nn_parity.py).

Outputs within 1e-5 of max(1, max |jax|) (complex results as complex);
gradients through |.| of complex results (torch cannot differentiate a
complex scalar loss) within 1e-4 (cuFFT / pocketfft and XLA's FFT sum in
other orders). ``istft`` is held to JAX's on the same spectrum, to the
signal itself after a round trip, and where the window fails NOLA (zeros
where no frame covers) to JAX's division by the envelope floor 1e-11. The
windows, filterbanks and DCT are built in float64 and rounded once where
JAX builds them in float32: within 1e-6 of the largest value (1e-5 for
the mel scale, the filterbank and the DCT, whose logs, and cosines of
arguments up to ~40 rad, JAX takes in float32).

Complex inputs take no gradient here: torch's gradient for a complex leaf
is the conjugate of JAX's; the gradients go through real paths instead.
"""

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from torch_nn_parity import F, as_np, check, compare

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


CASES = []


def case(name, fn, inputs, grad=(), tol=1e-5, gtol=1e-4):
    CASES.append(pytest.param(fn, inputs, grad, tol, gtol, id=name))


def C(*s):
    return (F(*s) + 1j * F(*s)).astype(np.complex64)


for _n in ("fft", "ifft", "rfft", "ihfft"):
    case(_n, lambda P, a, n=_n: getattr(P.fft, n)(a), [F(3, 8)])
    case(f"{_n}-n-axis-ortho", lambda P, a, n=_n: getattr(P.fft, n)(
        a, 6, 0, "ortho"), [F(5, 3)])
    case(f"{_n}-abs-grad", lambda P, a, n=_n: P.abs(getattr(P.fft, n)(
        a, norm="forward")), [F(3, 8)], (0,))
for _n in ("fft", "ifft", "irfft", "hfft"):
    case(f"{_n}-complex", lambda P, a, n=_n: getattr(P.fft, n)(a), [C(3, 5)])
    case(f"{_n}-complex-n", lambda P, a, n=_n: getattr(P.fft, n)(a, 8),
         [C(3, 5)])
case("irfft-grad", lambda P, a: P.fft.irfft(a), [F(3, 5)], (0,))
for _n in ("fft2", "ifft2", "rfft2", "fftn", "ifftn", "rfftn"):
    case(_n, lambda P, a, n=_n: getattr(P.fft, n)(a), [F(2, 4, 6)])
    case(f"{_n}-s-axes", lambda P, a, n=_n: getattr(P.fft, n)(
        a, s=[4, 4], axes=(0, 2)), [F(3, 2, 5)])
for _n in ("irfft2", "irfftn"):
    case(_n, lambda P, a, n=_n: getattr(P.fft, n)(a), [C(2, 4, 5)])
case("fftn-axes", lambda P, a: P.fft.fftn(a, axes=[1], norm="ortho"),
     [F(3, 4)])
case("fftshift", lambda P, a: P.fft.fftshift(a), [F(4, 5)], (0,))
case("fftshift-axes", lambda P, a: P.fft.fftshift(a, axes=[1]), [F(4, 5)])
case("ifftshift", lambda P, a: P.fft.ifftshift(a, axes=[0]), [F(5, 4)],
     (0,))
case("fftfreq", lambda P, a: [P.fft.fftfreq(9, 0.5), P.fft.fftfreq(8)],
     [F(1)])
case("rfftfreq", lambda P, a: [P.fft.rfftfreq(9, 0.25),
                               P.fft.rfftfreq(8)], [F(1)])
# ---- signal ----
case("frame", lambda P, a: P.signal.frame(a, 8, 3), [F(2, 3, 30)], (0,))
case("frame-axis0", lambda P, a: P.signal.frame(a, 8, 5, axis=0),
     [F(30, 2)], (0,))
case("overlap_add", lambda P, a: P.signal.overlap_add(a, 3),
     [F(2, 8, 5)], (0,))
case("overlap_add-axis0", lambda P, a: P.signal.overlap_add(a, 4, axis=0),
     [F(5, 8, 2)], (0,))
for _kw in (dict(), dict(center=False), dict(hop_length=5, win_length=12),
            dict(normalized=True), dict(onesided=False),
            dict(pad_mode="constant")):
    _id = "-".join(f"{k}={v}" for k, v in _kw.items()) or "default"
    case(f"stft-{_id}", lambda P, a, kw=_kw: P.signal.stft(a, 16, **kw),
         [F(2, 3, 64)])
case("stft-window", lambda P, a, w: P.signal.stft(
    a, 16, 4, 12, window=w), [F(2, 80), np.hanning(12).astype(np.float32)])
case("stft-abs-grad", lambda P, a, w: P.abs(P.signal.stft(
    a, 16, 4, window=w)), [F(2, 64), np.hanning(16).astype(np.float32)],
     (0,))
for _kw in (dict(), dict(center=False), dict(normalized=True),
            dict(length=50)):
    _id = "-".join(f"{k}={v}" for k, v in _kw.items()) or "default"
    case(f"istft-{_id}", lambda P, s, w, kw=_kw: P.signal.istft(
        s, 16, 4, window=w, **kw),
         [C(2, 9, 17), np.hanning(16).astype(np.float32) + 0.1])
# gradients through a real path (torch's gradient for a complex input is
# the conjugate of JAX's)
case("stft-istft-grad", lambda P, a, w: P.signal.istft(P.signal.stft(
    a, 16, 4, window=w), 16, 4, window=w),
     [F(2, 64), np.hanning(16).astype(np.float32) + 0.1], (0,))
case("istft-twosided", lambda P, s: P.signal.istft(s, 8, 2,
                                                     onesided=False),
     [C(8, 13)])
# NOLA fails: hop = n_fft and a window with zeros at its ends
case("istft-nola-floor", lambda P, s, w: P.signal.istft(
    s, 8, 8, window=w, center=False),
     [C(5, 4), np.array([0, 0, 1, 1, 1, 1, 0, 0], np.float32)])


@pytest.mark.parametrize("fn,inputs,grad,tol,gtol", CASES)
def test_against_jax(fn, inputs, grad, tol, gtol):
    check(fn, inputs, grad, tol, gtol)


def test_half_inputs_are_cast_to_float32():
    x = pt.to_tensor(F(3, 16)).astype("bfloat16")
    assert pt.fft.fft(x).dtype == torch.complex64
    assert pt.fft.rfft(x).dtype == torch.complex64
    assert pt.signal.stft(x, 8).dtype == torch.complex64
    j = jp.fft.fft(jp.to_tensor(F(3, 16)).astype("bfloat16"))
    assert str(np.asarray(j._data).dtype) == "complex64"


@pytest.mark.parametrize("window,hop", [("hann", 4), ("hamming", 8),
                                        ("blackman", 2)])
def test_stft_istft_round_trip(window, hop):
    x = F(2, 3, 200)
    w = pt.audio.functional.get_window(window, 16)
    spec = pt.signal.stft(pt.to_tensor(x), 16, hop, window=w)
    back = pt.signal.istft(spec, 16, hop, window=w, length=200)
    assert list(back.shape) == [2, 3, 200]
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


def test_istft_overlap_add_is_one_fold():
    """No loop over frames: the port's istft dispatches one op however
    many frames (JAX's Python loop adds two updates a frame)."""
    from paddle_tpu_torch.core import op_registry

    spec = pt.signal.stft(pt.randn([2, 4000]), 64, 16)
    op_registry.dispatched = 0
    pt.signal.istft(spec, 64, 16)
    assert op_registry.dispatched == 1 and spec.shape[-1] == 251


# ---- audio ----

@pytest.mark.parametrize("window", ["hann", "hamming", "blackman", "bohman",
                                    "triang", "bartlett", "rect", "cosine",
                                    ("kaiser", 8.0), ("gaussian", 3.0),
                                    ("exponential", None, 4.0)])
@pytest.mark.parametrize("fftbins", [True, False])
def test_get_window(window, fftbins):
    a = jp.audio.functional.get_window(window, 24, fftbins)
    b = pt.audio.functional.get_window(window, 24, fftbins)
    compare(b, a, 1e-6)
    assert b.dtype == torch.float32


@pytest.mark.parametrize("htk", [False, True])
def test_mel_scale_and_filterbanks(htk):
    JA, PA = jp.audio.functional, pt.audio.functional
    for f in (0.0, 440.0, 1000.0, 5512.5):
        assert abs(PA.hz_to_mel(f, htk) - JA.hz_to_mel(f, htk)) <= \
            1e-6 * max(1.0, abs(JA.hz_to_mel(f, htk)))
        m = JA.hz_to_mel(f, htk)
        assert abs(PA.mel_to_hz(m, htk) - JA.mel_to_hz(m, htk)) <= \
            1e-5 * max(1.0, f)
    hz = np.array([[0.0, 300.0], [1000.0, 8000.0]], np.float32)
    compare(PA.hz_to_mel(pt.to_tensor(hz), htk),
            JA.hz_to_mel(jp.to_tensor(hz), htk), 1e-5)
    compare(PA.mel_to_hz(pt.to_tensor(hz / 100), htk),
            JA.mel_to_hz(jp.to_tensor(hz / 100), htk), 1e-5)
    compare(PA.mel_frequencies(40, 20.0, 8000.0, htk),
            JA.mel_frequencies(40, 20.0, 8000.0, htk), 1e-5)
    compare(PA.fft_frequencies(16000, 512), JA.fft_frequencies(16000, 512),
            1e-6)
    for norm in ("slaney", None):
        compare(PA.compute_fbank_matrix(16000, 512, 40, 20.0, None, htk,
                                        norm),
                JA.compute_fbank_matrix(16000, 512, 40, 20.0, None, htk,
                                        norm), 1e-5)
    for norm in ("ortho", None):
        compare(PA.create_dct(13, 40, norm), JA.create_dct(13, 40, norm),
                1e-5)
    s = np.abs(F(2, 20, 7)) ** 2
    for top_db in (80.0, 10.0, None):
        compare(PA.power_to_db(pt.to_tensor(s), 2.0, 1e-10, top_db),
                JA.power_to_db(jp.to_tensor(s), 2.0, 1e-10, top_db), 1e-5)


FEATURES = [
    ("Spectrogram", dict(n_fft=64, hop_length=16, win_length=48)),
    ("Spectrogram", dict(n_fft=32, power=1.0, center=False)),
    ("MelSpectrogram", dict(sr=8000, n_fft=64, n_mels=16, f_min=20.0)),
    ("LogMelSpectrogram", dict(sr=8000, n_fft=64, n_mels=16, top_db=60.0)),
    ("MFCC", dict(sr=8000, n_mfcc=10, n_fft=64, n_mels=16)),
]


@pytest.mark.parametrize("cls,kw", FEATURES,
                         ids=[f"{c}-{i}" for i, (c, _) in
                              enumerate(FEATURES)])
def test_feature_layers(cls, kw):
    x = F(2, 400)
    ja = getattr(jp.audio.features, cls)(**kw)
    pa = getattr(pt.audio.features, cls)(**kw)
    compare(pa(pt.to_tensor(x)), ja(jp.to_tensor(x)), 1e-4)
    assert sorted(n for n, _ in pa.named_buffers()) == \
        sorted(n for n, _ in ja.named_buffers())


def test_spectrogram_is_differentiable():
    x = pt.to_tensor(F(2, 400), stop_gradient=False)
    pt.audio.features.Spectrogram(n_fft=64)(x).sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


@pytest.mark.parametrize("cls", ["ESC50", "TESS"])
def test_datasets_byte_equal(cls):
    a = getattr(jp.audio.datasets, cls)(size=3)
    b = getattr(pt.audio.datasets, cls)(size=3)
    assert len(a) == len(b) == 3
    for i in range(3):
        (wa, la), (wb, lb) = a[i], b[i]
        assert la == lb and np.array_equal(wa, wb)
    assert as_np(F(1)).shape == (1,)

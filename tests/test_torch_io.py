"""Port io (datasets, samplers, DataLoader, save/load) and the synthetic
vision datasets and transforms against the JAX package's (CPU).

Everything here is exact (tolerance 0): the synthetic images are drawn
from the same ``RandomState``, the samplers and random transforms from
numpy's global RNG under one ``np.random.seed``, and the loader's batches
are the same numpy arrays (the port's as CPU torch tensors: int64 for
integer samples, fp32 for floats, where the JAX package's integers are
int32 under its default x64-off config). ``Resize`` is the exception: it
is ``jax.image.resize``'s filter in numpy, within 1e-6 of the largest
value. Saved files are byte-equal both ways.
"""

import os
import sys
import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as JIO
import paddle_tpu.vision.datasets as JD
import paddle_tpu.vision.transforms as JT
import paddle_tpu_torch as pt
import paddle_tpu_torch.io as TIO
import paddle_tpu_torch.vision.datasets as TD
import paddle_tpu_torch.vision.transforms as TT
from paddle_tpu_torch.framework.io import DtypeUnavailableError

torch.set_num_threads(1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(getattr(x, "_data", x))


def _same_batches(jb, tb):
    """The same batch structure and values; the port's dtypes by rule.
    (The no-batch mode passes a tuple sample through as it is, in both.)"""
    if isinstance(jb, (list, tuple)):
        assert isinstance(tb, (list, tuple)) and len(jb) == len(tb)
        for a, b in zip(jb, tb):
            _same_batches(a, b)
        return
    if isinstance(jb, dict):
        assert sorted(jb) == sorted(tb)
        for k in jb:
            _same_batches(jb[k], tb[k])
        return
    if isinstance(jb, (np.ndarray, np.generic)):  # passed as it is
        assert type(tb) is type(jb)
        np.testing.assert_array_equal(tb, jb)
        return
    assert isinstance(tb, torch.Tensor) and tb.device.type == "cpu"
    a, b = _np(jb), tb.numpy()
    np.testing.assert_array_equal(b, a)
    if np.issubdtype(a.dtype, np.integer) and a.dtype != np.uint8:
        assert tb.dtype == torch.int64
    elif np.issubdtype(a.dtype, np.floating):
        assert tb.dtype == torch.float32
    else:
        assert b.dtype == a.dtype


# ---- datasets ----

@pytest.mark.parametrize("name,kw", [
    ("Cifar10", dict(size=64)), ("Cifar100", dict(mode="test", size=32)),
    ("MNIST", dict(size=48)), ("FashionMNIST", dict(mode="test", size=16)),
    ("Flowers", dict(size=4)), ("VOC2012", dict(mode="test", size=3)),
    ("Cifar10", dict(size=20, seed=5))])
def test_synthetic_datasets_are_byte_equal(name, kw):
    jd, td = getattr(JD, name)(**kw), getattr(TD, name)(**kw)
    assert len(td) == len(jd)
    np.testing.assert_array_equal(td.images, jd.images)
    np.testing.assert_array_equal(td.labels, jd.labels)
    img, label = td[len(td) - 1]
    assert img.dtype == np.uint8 and isinstance(label, np.int64)


def test_default_split_sizes_and_dataset_folder(tmp_path):
    assert len(TD.Cifar10()) == len(JD.Cifar10()) == 2048
    assert len(TD.VOC2012(mode="test")) == 128
    rng = np.random.default_rng(0)
    for c in ("b", "a"):
        os.makedirs(tmp_path / c)
        for i in range(3):
            np.save(tmp_path / c / f"{i}.npy",
                    rng.integers(0, 255, (4, 4, 3)).astype(np.uint8))
    jf, tf = JD.DatasetFolder(str(tmp_path)), TD.DatasetFolder(str(tmp_path))
    assert tf.class_to_idx == jf.class_to_idx == {"a": 0, "b": 1}
    for i in range(len(jf)):
        (ja, jl), (ta, tl) = jf[i], tf[i]
        np.testing.assert_array_equal(ta, ja)
        assert tl == jl


def _cifar_chain(M):
    return M.Compose([M.RandomCrop(32, padding=4), M.RandomHorizontalFlip(),
                      M.RandomVerticalFlip(0.3), M.BrightnessTransform(0.2),
                      M.ToTensor(),
                      M.Normalize([0.4914, 0.4822, 0.4465],
                                  [0.2470, 0.2435, 0.2616])])


def test_cifar_transform_chain_is_equal_under_one_seed():
    jd = JD.Cifar10(size=16, transform=_cifar_chain(JT))
    td = TD.Cifar10(size=16, transform=_cifar_chain(TT))
    np.random.seed(11)
    ref = [jd[i][0] for i in range(16)]
    np.random.seed(11)
    got = [td[i][0] for i in range(16)]
    for a, b in zip(ref, got):
        assert b.dtype == np.float32 and b.shape == (3, 32, 32)
        np.testing.assert_array_equal(b, a)
    img = jd.images[0]
    for make in (lambda M: M.CenterCrop(20), lambda M: M.Transpose(),
                 lambda M: M.ToTensor("HWC")):
        np.testing.assert_array_equal(make(TT)(img), make(JT)(img))
    np.testing.assert_array_equal(TT.to_tensor(img).numpy(),
                                  np.asarray(JT.to_tensor(img)._data))
    np.testing.assert_array_equal(
        TT.normalize(TT.to_tensor(img), [0.5] * 3, [0.2] * 3).numpy(),
        np.asarray(JT.normalize(JT.to_tensor(img), [0.5] * 3,
                                [0.2] * 3)._data))


@pytest.mark.parametrize("shape,size", [((32, 32, 3), (40, 20)),
                                        ((3, 32, 32), 16), ((28, 28), (7, 50))])
def test_resize_matches_jax_image_resize(shape, size):
    img = np.random.default_rng(1).integers(0, 255, shape).astype(np.uint8)
    ref, got = JT.Resize(size)(img), TT.Resize(size)(img)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_breadth_transforms_wait_for_a_later_slice():
    for name in ("ColorJitter", "RandomResizedCrop", "rotate", "Pad"):
        with pytest.raises(NotImplementedError, match="item 8"):
            getattr(TT, name)


# ---- datasets of io, random_split ----

def test_io_datasets_and_random_split():
    x = np.arange(24, dtype=np.float32).reshape(12, 2)
    y = np.arange(12)
    jt = JIO.TensorDataset([paddle.to_tensor(x), paddle.to_tensor(y)])
    tt = TIO.TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    assert len(tt) == 12
    for i in range(12):
        for a, b in zip(jt[i], tt[i]):
            np.testing.assert_array_equal(b, a)
    for lengths in ([5, 7], [0.25, 0.75]):
        np.random.seed(3)
        js = JIO.random_split(jt, lengths)
        np.random.seed(3)
        ts = TIO.random_split(tt, lengths)
        assert [s.indices for s in ts] == [s.indices for s in js]
    cat = TIO.ConcatDataset([tt, TIO.Subset(tt, [3, 1])])
    assert len(cat) == 14 and cat[13][1] == 1 and cat[-1][1] == 1
    comp = TIO.ComposeDataset([tt, tt])
    assert len(comp[2]) == 4
    chain = TIO.ChainDataset([_Stream(3), _Stream(2)])
    assert list(iter(chain)) == [0, 1, 2, 0, 1]


# ---- samplers ----

def _orders(mod, seed):
    ds = list(range(23))
    np.random.seed(seed)
    out = {
        "sequence": list(mod.SequenceSampler(ds)),
        "random": list(mod.RandomSampler(ds)),
        "random_replacement": list(mod.RandomSampler(
            ds, replacement=True, num_samples=30)),
        "random_num_samples": list(mod.RandomSampler(ds, num_samples=9)),
        "subset": list(mod.SubsetRandomSampler([4, 8, 15, 16, 23])),
        "weighted": list(mod.WeightedRandomSampler(
            [0.1, 2.0, 0.5, 1.0], num_samples=12)),
        "batch": list(mod.BatchSampler(ds, shuffle=True, batch_size=5)),
        "batch_drop": list(mod.BatchSampler(ds, batch_size=5,
                                            drop_last=True)),
    }
    for rank in (0, 1, 2):
        s = mod.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                        shuffle=True)
        s.set_epoch(7)
        out[f"distributed_{rank}"] = (list(s), len(s))
    s = mod.DistributedBatchSampler(ds, 4, num_replicas=2, rank=1,
                                    drop_last=True)
    out["distributed_plain"] = (list(s), len(s))
    return out


@pytest.mark.parametrize("seed", [0, 42])
def test_every_sampler_order_matches_jax(seed):
    ref, got = _orders(JIO, seed), _orders(TIO, seed)
    assert got == ref
    assert got["random"] != got["sequence"]


def test_distributed_batch_sampler_needs_no_process_group():
    s = TIO.DistributedBatchSampler(list(range(10)), 3)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert [len(b) for b in s] == [3, 3, 3, 1]


# ---- DataLoader ----

class _Pairs(JIO.Dataset, TIO.Dataset):
    """uint8 images with int64 labels and an fp64 feature (numpy only)."""

    def __init__(self, n=22):
        rng = np.random.RandomState(0)
        self.x = rng.randint(0, 255, (n, 3, 4, 4)).astype(np.uint8)
        self.f = rng.standard_normal((n, 2))
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.x[i], np.int64(i), self.f[i]


class _Dicts(_Pairs):
    def __getitem__(self, i):
        return {"x": self.x[i], "k": int(i), "w": float(i) / 2}


class _Stream(JIO.IterableDataset, TIO.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        return iter(range(self.n))


def _batches(mod, ds, seed, **kw):
    np.random.seed(seed)
    return list(mod.DataLoader(ds, **kw))


@pytest.mark.parametrize("mode", ["single", "single_shuffle", "dicts",
                                  "iterable", "no_batch", "workers",
                                  "workers_queue"])
def test_dataloader_batches_match_jax(mode):
    ds, kw = _Pairs(), dict(batch_size=4)
    if mode == "single_shuffle":
        kw.update(shuffle=True, drop_last=True)
    elif mode == "dicts":
        ds = _Dicts()
    elif mode == "iterable":
        ds = _Stream(11)
    elif mode == "no_batch":
        kw = dict(batch_size=None)
    elif mode.startswith("workers"):
        kw.update(shuffle=True, num_workers=2,
                  use_shared_memory=mode == "workers")
    ref, got = _batches(JIO, ds, 5, **kw), _batches(TIO, ds, 5, **kw)
    assert len(got) == len(ref) > 1
    for jb, tb in zip(ref, got):
        _same_batches(jb, tb)


class _Faulty(TIO.Dataset):
    def __init__(self, bad=(), exit_at=None):
        self.bad, self.exit_at = set(bad), exit_at

    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == self.exit_at:
            os._exit(3)
        if i in self.bad:
            raise ValueError(f"corrupt sample {i}")
        info = TIO.get_worker_info()
        return np.array([i, -1 if info is None else info.id], np.int64)


def test_worker_errors_skip_corrupt_and_worker_info():
    with pytest.raises(RuntimeError, match="corrupt sample 5"):
        list(TIO.DataLoader(_Faulty(bad=[5]), batch_size=4, num_workers=2))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        single = list(TIO.DataLoader(_Faulty(bad=[5, 6]), batch_size=4,
                                     skip_corrupt=True))
    assert [b[:, 0].tolist() for b in single] == [[0, 1, 2, 3], [4, 7],
                                                  [8, 9, 10, 11]]
    assert any("PT-DATA-002" in str(w.message) for w in caught)
    assert all((b[:, 1] == -1).all() for b in single)
    multi = list(TIO.DataLoader(_Faulty(bad=[5, 6]), batch_size=4,
                                num_workers=2, skip_corrupt=True))
    assert [b[:, 0].tolist() for b in multi] == [[0, 1, 2, 3], [4, 7],
                                                 [8, 9, 10, 11]]
    assert sorted({int(w) for b in multi for w in b[:, 1]}) == [0, 1]
    with pytest.raises(TIO.DataLoaderWorkerError, match="PT-DATA-001"):
        list(TIO.DataLoader(_Faulty(exit_at=9), batch_size=4, num_workers=2,
                            worker_respawn_limit=0))


def test_worker_init_fn_and_default_collate():
    seen = []
    out = list(TIO.DataLoader(_Faulty(), batch_size=6, num_workers=2,
                              worker_init_fn=seen.append))
    assert [b[:, 0].tolist() for b in out] == [list(range(6)),
                                               list(range(6, 12))]
    c = TIO.default_collate_fn([(torch.ones(2), 1, 0.5),
                                (torch.zeros(2), 2, 1.5)])
    assert c[0].shape == (2, 2) and c[1].dtype == torch.int64
    assert c[2].dtype == torch.float32


# ---- save / load ----

def _payload(mod):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = np.arange(6, dtype=np.int64).reshape(2, 3)
    c = rng.standard_normal(5).astype(np.float32).astype(ml_dtypes.bfloat16)
    if mod is pt:
        t = [torch.from_numpy(a), torch.from_numpy(b),
             torch.from_numpy(c.view(np.int16).copy()).view(torch.bfloat16)]
    else:
        t = [paddle.to_tensor(a), paddle.to_tensor(jnp.asarray(b)),
             paddle.Tensor(jnp.asarray(c))]
    return {"w": t[0], "nested": {"ids": t[1], "bf": [t[2], 3, "s"]},
            "step_count": 7, "lr": 0.25, "plain": np.ones(2, np.float32),
            "tup": (t[0], None)}


def test_save_files_are_byte_equal_both_ways(tmp_path):
    # JAX's int64 tensor is int32 (x64 off): give both sides int32 ids
    jobj, tobj = _payload(paddle), _payload(pt)
    tobj["nested"]["ids"] = tobj["nested"]["ids"].to(torch.int32)
    jp, tp = str(tmp_path / "j" / "a.pdparams"), str(tmp_path / "t.pdparams")
    paddle.save(jobj, jp)
    pt.save(tobj, tp)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    for path in (jp, tp):
        got = pt.load(path)
        assert got["step_count"] == 7 and got["lr"] == 0.25
        assert got["nested"]["bf"][0].dtype == torch.bfloat16
        assert torch.equal(got["nested"]["bf"][0], tobj["nested"]["bf"][0])
        assert torch.equal(got["w"], tobj["w"]) and got["tup"][1] is None
        assert got["nested"]["ids"].dtype == torch.int32
        ref = paddle.load(path)
        np.testing.assert_array_equal(np.asarray(ref["w"]._data),
                                      got["w"].numpy())
        assert pt.load(path, return_numpy=True)["nested"]["bf"][0].dtype == \
            ml_dtypes.bfloat16


def test_bf16_payload_without_ml_dtypes_raises_a_named_error(tmp_path,
                                                            monkeypatch):
    path = str(tmp_path / "bf.pdparams")
    bf = torch.ones(3, dtype=torch.bfloat16)
    pt.save({"x": bf, "y": torch.ones(2)}, path)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(DtypeUnavailableError, match="ml_dtypes"):
        pt.load(path)
    with pytest.raises(DtypeUnavailableError, match="ml_dtypes"):
        pt.save({"x": bf}, str(tmp_path / "other.pdparams"))
    pt.save({"y": torch.ones(2)}, str(tmp_path / "fp32.pdparams"))
    assert torch.equal(pt.load(str(tmp_path / "fp32.pdparams"))["y"],
                       torch.ones(2))

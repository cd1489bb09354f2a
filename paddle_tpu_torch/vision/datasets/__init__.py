"""Vision datasets — port of ``paddle_tpu/vision/datasets``: the JAX
package's synthetic splits with the real schema and shapes (HWC uint8
images, int64 labels), drawn from the same ``RandomState(seed + mode)`` so
the images are byte-equal in both packages; ``DatasetFolder`` reads local
files."""

from __future__ import annotations

import numpy as np

from ...io.dataset import Dataset


class _SyntheticImageDataset(Dataset):
    IMAGE_SHAPE = (3, 32, 32)
    NUM_CLASSES = 10
    SIZE = {"train": 50000, "test": 10000}

    def __init__(self, mode="train", transform=None, backend="cv2", size=None, seed=0):
        self.mode = mode
        self.transform = transform
        self.n = size or min(self.SIZE.get(mode, 1024), 2048)
        rng = np.random.RandomState(seed + (0 if mode == "train" else 1))
        c, h, w = self.IMAGE_SHAPE
        self.images = rng.randint(0, 256, (self.n, h, w, c), dtype=np.uint8)
        self.labels = rng.randint(0, self.NUM_CLASSES, (self.n,), dtype=np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.n


class Cifar10(_SyntheticImageDataset):
    IMAGE_SHAPE = (3, 32, 32)
    NUM_CLASSES = 10


class Cifar100(_SyntheticImageDataset):
    IMAGE_SHAPE = (3, 32, 32)
    NUM_CLASSES = 100


class MNIST(_SyntheticImageDataset):
    IMAGE_SHAPE = (1, 28, 28)
    NUM_CLASSES = 10

    def __init__(self, mode="train", transform=None, image_path=None, label_path=None, backend=None, size=None, seed=0):
        super().__init__(mode, transform, size=size, seed=seed)


class FashionMNIST(MNIST):
    pass


class Flowers(_SyntheticImageDataset):
    IMAGE_SHAPE = (3, 224, 224)
    NUM_CLASSES = 102
    SIZE = {"train": 1020, "test": 1020, "valid": 1020}


class VOC2012(_SyntheticImageDataset):
    IMAGE_SHAPE = (3, 224, 224)
    NUM_CLASSES = 21
    SIZE = {"train": 512, "test": 128}


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None, is_valid_file=None):
        import os

        self.root = root
        self.transform = transform
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                self.samples.append((os.path.join(cdir, fname), self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = np.load(path) if path.endswith(".npy") else np.asarray(_load_image(path))
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


ImageFolder = DatasetFolder


def _load_image(path):
    try:
        from PIL import Image

        return Image.open(path).convert("RGB")
    except ImportError as e:
        raise RuntimeError("PIL unavailable; use .npy images with DatasetFolder") from e

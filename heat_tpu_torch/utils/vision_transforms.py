"""Vision transforms (heat_tpu ``utils/vision_transforms.py``): a native
set, each a callable over tensors, and torchvision's transforms by name
where torchvision imports."""

from __future__ import annotations

import torch

__all__ = ["Compose", "Normalize", "ToTensor", "Lambda"]


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class Normalize:
    """``(x - mean) / std``."""

    def __init__(self, mean, std):
        self.mean = torch.as_tensor(mean)
        self.std = torch.as_tensor(std)

    def __call__(self, x):
        return (x - self.mean.to(x.device)) / self.std.to(x.device)


class ToTensor:
    """uint8 HWC to float CHW in [0, 1]."""

    def __call__(self, x):
        x = torch.as_tensor(x)
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
        if x.ndim == 3:
            x = torch.movedim(x, -1, 0)
        return x


class Lambda:
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, x):
        return self.fn(x)


def __getattr__(name):
    try:
        import torchvision.transforms as _tvt

        return getattr(_tvt, name)
    except ImportError:
        raise AttributeError(
            f"transform {name!r} is not in the native set and torchvision is unavailable")

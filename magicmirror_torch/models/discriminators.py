"""The WGAN critic, the port of ``Discriminator`` of
``magicmirror/models/discriminators.py``: 15 norm-free convolutions with
LeakyReLU(0.2), a near-zero-init 1x1 head, the mean over the patch map."""
from __future__ import annotations

from .blocks import Conv, FlaxNamed, leaky_relu


class Discriminator(FlaxNamed):
    """NHWC images (B, H, W, nc) -> (B, 1)."""

    def __init__(self, nc: int = 3, nf: int = 16, use_bias: bool = False):
        super().__init__()
        # (features, kernel, stride)
        spec = [(nf, 1, 1), (nf, 3, 1), (nf * 2, 3, 2), (nf * 2, 3, 1), (nf * 3, 3, 2),
                (nf * 3, 3, 1), (nf * 4, 3, 2), (nf * 4, 3, 1), (nf * 4, 3, 2),
                (nf * 4, 3, 1), (nf * 4, 3, 2), (nf * 4, 3, 1), (nf * 3, 3, 2),
                (nf * 2, 1, 1)]
        cin = nc
        for features, k, stride in spec:
            self.child(Conv(cin, features, k, stride=stride, padding=k // 2, bias=use_bias))
            cin = features
        self.child(Conv(cin, 1, 1, bias=use_bias, classifier=True))
        self.depth = len(spec)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(self.depth):
            x = leaky_relu(getattr(self, f"Conv_{i}")(x))
        return getattr(self, f"Conv_{self.depth}")(x).mean(dim=(2, 3))

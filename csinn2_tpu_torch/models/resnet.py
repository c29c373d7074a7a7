"""ResNet-50 (counterpart of csinn2_tpu/models/resnet.py; BASELINE.md
config 2: INT8 symmetric per-channel, NCHW and NHWC).  Bottleneck blocks,
BN folded into the convs (the deployment form); the residual join and its
relu fuse into the c3 conv's epilogue, one requantize a block tail.  Seeded
weights come from numpy exactly as in the JAX package."""

from __future__ import annotations

import numpy as np

from csinn2_tpu_torch.core.tensor import Tensor
from csinn2_tpu_torch.models.common import NetBuilder, kaiming
from csinn2_tpu_torch.models.mobilenet import _CnnModel


class ResNet50(_CnnModel):
    name = "resnet50"
    # (blocks, channels) per stage; bottleneck expansion 4
    CFG = [(3, 64), (4, 128), (6, 256), (3, 512)]

    def init_weights(self, rng):
        w = self.weights
        w["conv0.w"] = kaiming(rng, (64, 3, 7, 7))
        w["conv0.b"] = np.zeros((64,), np.float32)
        cin = 64
        for si, (n, ch) in enumerate(self.CFG):
            for bi in range(n):
                pre = f"s{si}.b{bi}"
                cout = ch * 4
                w[f"{pre}.c1.w"] = kaiming(rng, (ch, cin, 1, 1))
                w[f"{pre}.c1.b"] = np.zeros((ch,), np.float32)
                w[f"{pre}.c2.w"] = kaiming(rng, (ch, ch, 3, 3))
                w[f"{pre}.c2.b"] = np.zeros((ch,), np.float32)
                w[f"{pre}.c3.w"] = kaiming(rng, (cout, ch, 1, 1))
                w[f"{pre}.c3.b"] = np.zeros((cout,), np.float32)
                if bi == 0:
                    w[f"{pre}.down.w"] = kaiming(rng, (cout, cin, 1, 1))
                    w[f"{pre}.down.b"] = np.zeros((cout,), np.float32)
                cin = cout
        w["fc.w"] = kaiming(rng, (self.num_classes, 2048))
        w["fc.b"] = np.zeros((self.num_classes,), np.float32)

    def forward(self, b: NetBuilder, x: Tensor) -> Tensor:
        x = b.conv(x, "conv0", stride=2, relu=True)
        x = b.maxpool(x, "pool0", k=3, stride=2, pad=(1, 1, 1, 1))
        for si, (n, ch) in enumerate(self.CFG):
            for bi in range(n):
                pre = f"s{si}.b{bi}"
                stride = 2 if (bi == 0 and si > 0) else 1
                identity = x
                h = b.conv(x, f"{pre}.c1", stride=1, relu=True)
                h = b.conv(h, f"{pre}.c2", stride=stride, relu=True)
                if bi == 0:
                    identity = b.conv(x, f"{pre}.down", stride=stride)
                x = b.conv(h, f"{pre}.c3", stride=1, add=identity, relu=True)
        x = b.global_pool(x, "gap")
        x = b.flatten(x)
        x = b.fc(x, "fc")
        return x

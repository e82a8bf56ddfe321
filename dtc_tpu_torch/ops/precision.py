"""FP32 matmul policy.

Port of ``dtc_tpu/ops/precision.py``. The reference pins quantum-state
contractions to full f32 because reduced-precision gate products drift
the noiseless |A(t)| visibly. On the GPU the reduced format is TF32
(10-bit mantissa), which float32 matmuls and cuDNN may use unless told
not to; this module turns both off and checks that they stay off.
"""

from __future__ import annotations

import torch


def set_fp32_policy() -> None:
    """Full-f32 matmuls: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def assert_fp32_policy() -> None:
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; call set_fp32_policy()")
    if torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 cuDNN is on; call set_fp32_policy()")

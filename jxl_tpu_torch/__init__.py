"""jxl_tpu_torch — the JPEG XL decode engine on PyTorch and CUDA.

A port of the JAX package jxl_tpu, which stays in the repository as the
reference. The host side (numpy + C++) parses the bitstream and decodes
the entropy-coded sections; the render runs on torch tensors on the
caller's device, with the restoration-filter chain as a hand-written
CUDA kernel for Hopper (ops/epf_gab.py, csrc/epf_gab.cu).

decode_image decodes whole files: Modular and VarDCT frames (one pass or
several), animations, cropped and blended frames, reference frames and
patches, splines, LF frames and embedded ICC profiles, with every frame's
render on the caller's device; a lossless Modular frame's channel-static
streams can reconstruct on the card (JXL_TPU_DEV_LOSSLESS,
modular/device_lossless.py). decode_banded decodes the last frame one
group row at a time into the caller's sink, holding O(band) on the card.
"""

import torch

# jxl_tpu pins float32 math; keep TF32 off for matmuls and convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .api.banded import decode_banded  # noqa: E402
from .api.simple import DecodedImage, decode_image  # noqa: E402
from .errors import NotSupported  # noqa: E402

__all__ = ["DecodedImage", "NotSupported", "decode_banded", "decode_image"]

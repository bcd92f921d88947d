"""PyTorch/CUDA port of ``pointnav_vo_tpu`` for NVIDIA Hopper.

Module names follow the JAX package, so each module here has a counterpart
of the same path there.  Public functions keep the JAX layouts
(observations NHWC ``[B, H, W, C]``, deltas ``[B, 3]``, packed recurrent
state ``[2L, N, H]``); modules inside are NCHW ``nn.Module``s.

The package imports torch and numpy only: nothing of JAX, flax or
``pointnav_vo_tpu``.  Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.
"""

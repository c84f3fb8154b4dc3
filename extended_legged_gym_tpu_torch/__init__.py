"""PyTorch/CUDA port of ``extended_legged_gym_tpu``.

The JAX package beside this one is the reference; every module here keeps the
name of its counterpart there so a reader can hold the two side by side.  The
port imports ``torch`` and numpy only, never JAX, flax, optax or the JAX
package.

Conventions:
* batched tensors are ``[B, ...]`` (envs first), float32 throughout;
* TF32 is switched off for matmuls and cuDNN (:func:`utils.device.resolve_device`
  sets both), because the contact solve needs full float32, as the JAX
  engine forces f32 matmuls for the same reason;
* randomness comes from explicit ``torch.Generator`` objects; tests inject
  the draws instead, since JAX's PRNG streams cannot be reproduced here;
* entry points take ``device=`` and default to ``"cuda"``: they raise when
  CUDA is absent unless the caller asks for ``"cpu"``.

The one hand-written kernel is the fused, decimated flat physics step
(``csrc/physics_step.cu``, wrapped by ``ops/physics_kernel.py``).
"""

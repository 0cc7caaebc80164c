"""visual_slam_tpu — a visual SLAM framework for accelerators in JAX/XLA.

Built from scratch with the capabilities of the reference implementation
(juuso-oskari/visual_slam; see SURVEY.md): feature front-end, two-view
geometry, PnP tracking, map management, and bundle adjustment — expressed as
batched, fixed-shape, sharded computation.
"""

import jax as _jax

# Default-precision float32 matmuls may round their inputs (bf16 or TF32 on
# the matrix units); SLAM geometry (pose chains, BA normal equations, LM
# pose updates) is iterative f32 math where that rounding compounds into
# centimetres of trajectory error (measured: ATE 0.018 -> 0.062 on lr traj3
# with bf16-rounded inputs). Full-rate bf16 stays
# available where it is EXACT — the ±1 descriptor-distance matmuls pass
# precision=DEFAULT explicitly (ops/match.py, models/loop_closure.py).
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"

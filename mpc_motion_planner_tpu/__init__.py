"""mpc_motion_planner_tpu — batched minimum-time MPC motion planning.

A brand-new JAX/XLA framework with the capabilities of the C++
reference ``AlbericDeLajarte/mpc_motion_planner``: minimum-time joint-space
trajectory optimization for 7-DoF arms under position/velocity/acceleration
box constraints, RNEA torque limits and an end-effector height constraint,
with a jerk-limited time-optimal warm start. Solves batch thousands of
trajectories per chip and shard across device meshes.
"""

__version__ = "0.1.0"

from .models.panda import (  # noqa: F401
    NDOF,
    PandaLimits,
    TOOL_FRAME,
    make_panda_limits,
    make_panda_model,
)
from .models.robot import Frame, RobotModel  # noqa: F401
from .models.urdf import parse_urdf  # noqa: F401

from lins_tpu_torch.imu.eskf import (
    FilterState, box_plus, box_minus, init_covariance, process_noise,
    initial_state, predict_step, propagate, propagate_sequential,
    reset_relative, calculate_rp_from_gravity,
    POS, VEL, ATT, ACC, GYR, GRA, DIM)
from lins_tpu_torch.imu.preintegration import (
    Preintegration, init_preintegration, midpoint_step, preintegrate,
    solve_gyro_bias)

"""EKF, PID, control and the batched closed-loop agent tick."""

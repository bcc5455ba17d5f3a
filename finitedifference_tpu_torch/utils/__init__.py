from finitedifference_tpu_torch.utils.timers import phase_breakdown, Timer

__all__ = ["phase_breakdown", "Timer"]

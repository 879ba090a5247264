from gem_tpu_torch.multirobot.fleet import (  # noqa: F401
    fleet_effective_config,
    fleet_step,
    make_fleet_state,
    stack_frames,
)

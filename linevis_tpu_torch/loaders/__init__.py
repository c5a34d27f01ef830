from linevis_tpu_torch.loaders.stress_dat import (  # noqa: F401
    load_degenerate_points_dat,
    load_stress_trajectories_from_dat_v1,
    load_stress_trajectories_from_dat_v2,
    load_stress_trajectories_from_dat_v3,
)

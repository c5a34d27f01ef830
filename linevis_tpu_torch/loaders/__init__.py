from linevis_tpu_torch.loaders.obj_loader import load_trajectories_from_obj  # noqa: F401
from linevis_tpu_torch.loaders.binlines import (  # noqa: F401
    load_trajectories_from_binlines,
    save_trajectories_as_binlines,
)
from linevis_tpu_torch.loaders.stress_dat import (  # noqa: F401
    load_degenerate_points_dat,
    load_stress_trajectories_from_dat_v1,
    load_stress_trajectories_from_dat_v2,
    load_stress_trajectories_from_dat_v3,
)
from linevis_tpu_torch.loaders.dataset_list import (  # noqa: F401
    DataSetInformation,
    load_dataset_list,
)
from linevis_tpu_torch.loaders.flow_file import load_flow_trajectories_from_file  # noqa: F401

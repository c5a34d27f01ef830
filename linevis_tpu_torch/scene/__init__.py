from linevis_tpu_torch.scene.filters import (  # noqa: F401
    LineFilter,
    LineLengthFilter,
    MaxLineAttributeFilter,
)
from linevis_tpu_torch.scene.line_data import LineData, LineDataFlow  # noqa: F401
from linevis_tpu_torch.scene.line_data_stress import LineDataStress  # noqa: F401
from linevis_tpu_torch.scene.triangle_mesh_data import TriangleMeshData  # noqa: F401

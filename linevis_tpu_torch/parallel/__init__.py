"""Multi-GPU image-space parallelism through torch.distributed
(`parallel/mesh.py`)."""

from linevis_tpu_torch.parallel.mesh import make_device_mesh, render_opaque_sharded  # noqa: F401

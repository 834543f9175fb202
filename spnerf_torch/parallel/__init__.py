from .mesh import DataMesh, data_mesh, device_count, local_batch

__all__ = ["DataMesh", "data_mesh", "device_count", "local_batch"]

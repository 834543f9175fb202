from .jsonio import get_file_id, read_dict_from_json, write_dict_to_json
from .tiff import read_geotiff, read_tiff, write_geotiff

__all__ = [
    "read_tiff",
    "read_geotiff",
    "write_geotiff",
    "read_dict_from_json",
    "write_dict_to_json",
    "get_file_id",
]

"""JSON and file-name helpers (`spnerf_tpu/io/jsonio.py`)."""

import json
import os


def get_file_id(filename):
    """Basename without directory or extension."""
    return os.path.splitext(os.path.basename(filename))[0]


def read_dict_from_json(input_path):
    with open(input_path) as f:
        return json.load(f)


def write_dict_to_json(d, output_path):
    with open(output_path, "w") as f:
        json.dump(d, f, indent=2)
    return d

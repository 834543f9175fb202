"""The JAX package's environment switches that change what it computes.

Each one below makes `spnerf_tpu` round, drop or reinterpret values that
the port keeps in float32, exactly summed, in one layout. The port does not
reproduce them; where one is set, the code that would read it raises
instead of ignoring it. README's table classifies every SPNERF_* switch.
"""

import os

# name -> (is it set to the changing value, what it does in the JAX package)
REFUSED = {
    "SPNERF_HASH_BF16_GATHER": (
        lambda v, env: v == "1",
        "gathers the hash table from a bfloat16 copy"),
    "SPNERF_HASH_BF16_E2E": (
        lambda v, env: v == "1",
        "gathers the hash table in bfloat16 and interpolates in bfloat16"),
    "SPNERF_HASH_SW_BF16SORT": (
        lambda v, env: v == "1",
        "rounds the table gradient's cotangents to bfloat16"),
    "SPNERF_HASH_SW_TAIL": (
        lambda v, env: v == "0",
        "drops the table-gradient rows outside a sorted window"),
    "SPNERF_HASH_FMAJOR": (
        lambda v, env: v == "0",
        "orders the flat hash table t-major, another meaning of the same "
        "parameter"),
    "SPNERF_HASH_MATMUL_PALLAS": (
        lambda v, env: v == "0" and env.get("SPNERF_HASH_MATMUL_F32") != "1",
        "takes the table gradient through the XLA one-hot matmul with "
        "bfloat16 cotangents (unless SPNERF_HASH_MATMUL_F32=1)"),
    "SPNERF_PDF_LOOKUP": (
        lambda v, env: v == "matmul",
        "looks the inverse-CDF bins up by a one-hot matmul at the backend's "
        "default precision (bfloat16 passes on a TPU)"),
}
HASH_SWITCHES = tuple(k for k in REFUSED if k.startswith("SPNERF_HASH_"))


def refuse(names):
    """Raise if any of `names` (keys of REFUSED) is set to its changing
    value."""
    for name in names:
        value = os.environ.get(name)
        changes, what = REFUSED[name]
        if value is not None and changes(value, os.environ):
            raise ValueError(
                f"{name}={value}: in the JAX package this {what}, an "
                "experiment it records as refuted; the port does not compute "
                f"that. Unset {name}.")

"""LDPC code data and host-side GF(2) preprocessing."""

from .ldpc import (
    LdpcCode,
    get_code,
    get_sim_dsource,
    list_codes,
    make_ldpc,
    reorder_h,
    unpack_hex_rows,
)

__all__ = [
    "LdpcCode",
    "get_code",
    "get_sim_dsource",
    "list_codes",
    "make_ldpc",
    "reorder_h",
    "unpack_hex_rows",
]

"""The yardstick's fixed numbers: the card's published peak and the bytes
each operation needs, counted from its inputs and outputs so that the
count is the same whatever kernels implement it."""

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 bandwidth, bytes a second
PEAK_HBM_BYTES_PER_S = 3.35e12


def decode_bytes(container: int, decoded: int) -> int:
    """A decode reads each container byte once and writes each decoded
    byte once."""
    return container + decoded


def compress_bytes(data: int, container: int) -> int:
    """A compress reads each input byte once and writes each container
    byte once."""
    return data + container


# a traffic mix's "roofline" key: (a call's argument's bytes, its answer's)
BYTES = {"decode": decode_bytes, "compress": compress_bytes}


def least_seconds(nbytes: int) -> float:
    """The least time the card can move ``nbytes`` in."""
    return nbytes / PEAK_HBM_BYTES_PER_S

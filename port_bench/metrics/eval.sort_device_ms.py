"""Device milliseconds a traced room spends in the build's sort, scan and
search kernels, over the traced rooms' kernels as ``trace.read`` names them:
the radix sorts of the keys (and of two-column keys' argsorts), the
``cummax`` scans of the merged lookups (d > 3), the ``cumsum`` scans, and
the binary searches of one-column lookups (d <= 3)."""

from port_bench import trace

UNIT = "ms"
# fragments of the kernel names, as a traced room on an H100 (torch 2.11, CUDA 12.8) names them
SORT_SCAN_KERNEL_NAMES = (
    "DeviceRadixSort",  # cub's Onesweep, Histogram and ExclusiveSum passes of torch.sort / argsort
    "DeviceScan",  # cub's DeviceScanKernel and DeviceScanInitKernel of torch.cumsum
    "tensor_kernel_scan_innermost_dim_with_indices",  # torch.cummax
    "searchsorted_cuda_kernel",  # torch.searchsorted
)


def read(reading):
    tr = reading["layer"].get("trace")
    if tr is None:
        return None
    return trace.k1_device_us(tr, SORT_SCAN_KERNEL_NAMES) / 1e3 / reading["traffic"]["trace_items"]

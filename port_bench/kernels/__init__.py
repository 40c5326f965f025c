"""One file a kernel of the port: the bytes and operations a launch needs
at given shapes (``counts``), its roofline bound (``bound``, seconds and
what bounds it), the CUDA kernel names it shows in the profiler's trace
(``KERNEL_NAMES``) and how many of them one call launches
(``KERNELS_PER_CALL``)."""

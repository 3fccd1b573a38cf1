"""``ssd_scan``'s share of its roofline in the traced prefills, in %: its
work at the shapes it is launched at (``scan_work``, frozen in
``bench/work.py``, one call a layer) over the device time of its kernel
(``ssd_scan_kernel``) inside the prefill spans
(``readers.kernel_roofline``)."""

from readers import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "ssd_scan", "scan")

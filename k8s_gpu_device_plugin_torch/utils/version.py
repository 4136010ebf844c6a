"""Framework version (the port's copy of the reference's
``utils/version.py``; the ``version`` label of ``gpu_plugin_build_info``)."""

VERSION = "0.1.0"

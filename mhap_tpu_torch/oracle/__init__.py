"""The numpy reference pipeline behind ``--backend oracle`` (the port's
copy of mhap_tpu/oracle): host code only, independent of the port's
device path (it imports nothing of ``ops/``, ``index/``, ``pipeline/`` or
``io/filter.py``), which the tests hold against it."""

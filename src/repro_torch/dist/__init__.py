"""Distribution layer of the port: the logical-axis rules and
``constrain`` (``dist/logical.py``) and gradient compression
(``dist/compress.py``)."""

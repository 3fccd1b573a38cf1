"""Language models of the port: the dense and VLM decoder stack
(``transformer``) on the shared substrate (``common``), the reference
parameter bridge (``weights``) and the family-uniform API (``registry``)."""

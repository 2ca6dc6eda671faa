"""Entry points: the batched serving plane (``serve``) and its steps (``steps``)."""

"""Entry points: the serving planes (``serve``), the training driver
(``train``) and their steps (``steps``)."""

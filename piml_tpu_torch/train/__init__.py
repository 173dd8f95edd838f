"""Training: the loss library (``losses``) and the finetune loop
(``trainer``).  Import the modules themselves: ``engine.simulator`` reads
``losses``, and ``trainer`` reads ``engine.simulator``."""

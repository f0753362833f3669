"""Training on one card: the train step with accumulation and an EMA shadow
(``trainer``), low-rank adapters (``lora``) and the example-to-packed-batch
pipeline (``dataset``)."""

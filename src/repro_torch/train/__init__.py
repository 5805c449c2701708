"""Training: AdamW (``optimizer``), the train step (``train_step``), the
gradient codec (``compress``) and the fault-tolerant loop (``trainer``)."""

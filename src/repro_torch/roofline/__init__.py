"""Roofline terms of a counted step (``count``, ``analysis``) and the
renderers of the dry run's records (``report``, ``experiments_md``)."""

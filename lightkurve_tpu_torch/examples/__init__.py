"""Worked examples of the batched transit search on the card
(:mod:`.sector_search`, :mod:`.multi_sector_sweep`); run each with
``python -m``.  Importing this package imports nothing."""

"""The drivers of the main path's north-star search: the synthetic sector
generator (:mod:`.make_sector`) and the search itself
(:mod:`.northstar_run`).  Importing this package imports nothing."""

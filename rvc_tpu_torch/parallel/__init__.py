"""Several cards: the batch split over one process a rank
(``mesh.py``), and the dry run that checks it (``dryrun.py``)."""

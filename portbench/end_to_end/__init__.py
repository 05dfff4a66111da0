"""One reader an end-to-end metric: ``end_to_end/<name>.py`` defines
``read(r)`` over the run's window (``core.Window``)."""

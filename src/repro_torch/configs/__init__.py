"""Architecture configs of the model stack: one module per architecture,
each exporting ``CONFIG`` (copied as data from ``repro/configs``)."""

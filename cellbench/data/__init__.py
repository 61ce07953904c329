"""One data maker per kind of data a configuration names (``"data"``)."""

"""One least-work reckoner per kind of data a configuration names (``"work"``)."""

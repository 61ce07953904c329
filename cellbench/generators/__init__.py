"""One traffic generator per kind of traffic a mix names (``"generator"``)."""

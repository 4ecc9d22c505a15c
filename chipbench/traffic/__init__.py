"""Traffic mixes (``<mix>.json``) and the loops that drive their kinds
(``<kind>.py``)."""

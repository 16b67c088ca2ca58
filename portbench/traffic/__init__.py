"""Traffic mixes (``<mix>.json``) and one generator a kind
(``<kind>.py``)."""

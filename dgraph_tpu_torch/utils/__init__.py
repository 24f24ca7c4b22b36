"""Host utilities (stdlib only): the dataclass CLI bridge."""

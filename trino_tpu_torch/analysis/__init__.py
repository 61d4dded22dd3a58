"""Static analysis of plans: the plan sanity checker."""

"""Farm helpers the settings layer and the scheduler need: tenant
labels, shares and the fair-usage key (farm/tenancy.py). The capacity
controller, worker lifecycle and providers are not ported yet (ROADMAP
A13b)."""

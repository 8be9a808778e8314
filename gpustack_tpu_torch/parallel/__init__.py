"""Multi-GPU placement: mesh plans, sharding rules and the collectives."""

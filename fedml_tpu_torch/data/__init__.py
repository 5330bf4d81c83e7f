"""The federated dataset contract, packing, and dataset builders."""

"""FEL of the PyTorch port: clients, FedAvg, the hierarchy, the MLP
adapter and the BHFL runtime. Import them from their modules."""

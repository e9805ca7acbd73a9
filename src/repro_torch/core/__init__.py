"""Core library of the port: hypergraph, HL-index construction and
minimisation (host, numpy), padded label snapshots and batched joins
(device, torch), and the engine facade over them."""

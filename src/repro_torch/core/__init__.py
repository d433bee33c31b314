"""CE-FedAvg core of the port: topology, round programs, runtime model,
the flat model bank, the simulator and the event clock."""

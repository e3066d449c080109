"""The single-node half of the reference's transport package: the task
manager (tasks.py). The wire half (bans sent to other nodes, children
registered for incoming requests) comes with the cluster layer."""

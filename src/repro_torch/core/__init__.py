"""Planning layer of the port: ``MemoryPlan`` and the serving page geometry."""

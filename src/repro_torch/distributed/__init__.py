"""Multi-device helpers of the port: scenario-axis sharding, elastic
meshes and the serving watchdog, and gradient compression."""

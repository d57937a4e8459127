"""Host-side data for the port: scan logs, ROS1 bags and synthetic worlds
in NumPy; ``ScanLog`` hands the engines tensors on a device."""

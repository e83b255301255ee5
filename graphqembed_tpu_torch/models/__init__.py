"""Parameter trees and the GQE model on device-resident batches."""
